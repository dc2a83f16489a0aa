// framestore — native frame ingest runtime for lk_tpu.
//
// The reference's ingest is cv.VideoCapture called synchronously once per
// frame on the Python thread (reference LK_Final.py:509); at accelerator
// batch rates the host must instead stage frames ahead of the device.  This
// library provides:
//
//   * an mmap'd reader for the LKRAW container (magic "LKRW", u32 w, h,
//     channels, nframes; then raw u8 frames) — the framework's zero-decode
//     interchange format for benchmarks and tests;
//   * a producer thread that stages upcoming frames into a ring of
//     host-pinned-sized buffers (memcpy from the page cache, optional
//     on-host downscale-by-2), so Python's next_batch() is a wait-free copy
//     and jax.device_put overlaps with staging;
//   * C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -shared -fPIC -pthread framestore.cpp -o libframestore.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Header {
  char magic[4];
  uint32_t width;
  uint32_t height;
  uint32_t channels;
  uint32_t nframes;
};

struct FrameStore {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t map_size = 0;
  Header hdr{};
  size_t frame_bytes = 0;

  // ring of staged frames
  size_t ring_cap = 0;
  std::vector<std::vector<uint8_t>> ring;
  std::vector<int64_t> ring_idx;      // which frame occupies each slot
  std::atomic<int64_t> head{0};        // next frame index to stage
  std::atomic<int64_t> tail{0};        // next frame index to consume
  int downscale = 1;                   // 1 or 2 (box 2x2 average)

  std::thread producer;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::atomic<bool> stop{false};

  size_t out_w() const { return hdr.width / downscale; }
  size_t out_h() const { return hdr.height / downscale; }
  size_t out_bytes() const { return out_w() * out_h() * hdr.channels; }

  void stage(int64_t idx, uint8_t* dst) const {
    const uint8_t* src = map + sizeof(Header) + (size_t)idx * frame_bytes;
    if (downscale == 1) {
      std::memcpy(dst, src, frame_bytes);
      return;
    }
    // 2x2 box average downscale, per channel
    const size_t w = hdr.width, c = hdr.channels;
    const size_t ow = out_w(), oh = out_h();
    for (size_t y = 0; y < oh; ++y) {
      const uint8_t* r0 = src + (2 * y) * w * c;
      const uint8_t* r1 = src + (2 * y + 1) * w * c;
      uint8_t* d = dst + y * ow * c;
      for (size_t x = 0; x < ow; ++x) {
        for (size_t k = 0; k < c; ++k) {
          unsigned v = r0[(2 * x) * c + k] + r0[(2 * x + 1) * c + k] +
                       r1[(2 * x) * c + k] + r1[(2 * x + 1) * c + k];
          d[x * c + k] = (uint8_t)((v + 2) >> 2);
        }
      }
    }
  }

  void run_producer() {
    while (!stop.load()) {
      std::unique_lock<std::mutex> lk(mu);
      cv_full.wait(lk, [&] {
        return stop.load() ||
               (head.load() - tail.load() < (int64_t)ring_cap &&
                head.load() < (int64_t)hdr.nframes);
      });
      if (stop.load()) return;
      int64_t idx = head.load();
      if (idx >= (int64_t)hdr.nframes) return;
      size_t slot = (size_t)(idx % ring_cap);
      lk.unlock();
      stage(idx, ring[slot].data());
      lk.lock();
      ring_idx[slot] = idx;
      head.store(idx + 1);
      cv_empty.notify_all();
      if (head.load() >= (int64_t)hdr.nframes) return;
    }
  }
};

}  // namespace

extern "C" {

void* fs_open(const char* path, int ring_cap, int downscale) {
  if (downscale != 1 && downscale != 2) return nullptr;
  auto* fs = new FrameStore();
  fs->fd = ::open(path, O_RDONLY);
  if (fs->fd < 0) { delete fs; return nullptr; }
  struct stat st;
  if (fstat(fs->fd, &st) != 0) { ::close(fs->fd); delete fs; return nullptr; }
  fs->map_size = (size_t)st.st_size;
  if (fs->map_size < sizeof(Header)) {
    ::close(fs->fd);
    delete fs;
    return nullptr;
  }
  fs->map = (const uint8_t*)mmap(nullptr, fs->map_size, PROT_READ,
                                 MAP_PRIVATE, fs->fd, 0);
  if (fs->map == MAP_FAILED) { ::close(fs->fd); delete fs; return nullptr; }
  std::memcpy(&fs->hdr, fs->map, sizeof(Header));
  fs->frame_bytes =
      (size_t)fs->hdr.width * fs->hdr.height * fs->hdr.channels;
  if (std::memcmp(fs->hdr.magic, "LKRW", 4) != 0 || fs->frame_bytes == 0) {
    munmap((void*)fs->map, fs->map_size);
    ::close(fs->fd);
    delete fs;
    return nullptr;
  }
  // A truncated/corrupt file must not let stage() read past the mapping:
  // clamp nframes to the full frames actually present in the file.
  size_t avail = (fs->map_size - sizeof(Header)) / fs->frame_bytes;
  if ((size_t)fs->hdr.nframes > avail) fs->hdr.nframes = (uint32_t)avail;
  fs->downscale = downscale;
  fs->ring_cap = ring_cap > 0 ? (size_t)ring_cap : 8;
  fs->ring.resize(fs->ring_cap);
  fs->ring_idx.assign(fs->ring_cap, -1);
  for (auto& b : fs->ring) b.resize(fs->out_bytes());
  fs->producer = std::thread([fs] { fs->run_producer(); });
  return fs;
}

int fs_width(void* h) { return (int)((FrameStore*)h)->out_w(); }
int fs_height(void* h) { return (int)((FrameStore*)h)->out_h(); }
int fs_channels(void* h) { return (int)((FrameStore*)h)->hdr.channels; }
int64_t fs_nframes(void* h) { return ((FrameStore*)h)->hdr.nframes; }

// Copy up to n staged frames into dst (n * out_bytes). Returns count (0 at
// end of stream). Blocks until at least one frame is staged.
int fs_next_batch(void* h, uint8_t* dst, int n) {
  auto* fs = (FrameStore*)h;
  int got = 0;
  while (got < n) {
    std::unique_lock<std::mutex> lk(fs->mu);
    int64_t t = fs->tail.load();
    if (t >= (int64_t)fs->hdr.nframes) break;
    if (fs->head.load() <= t) {
      if (got > 0) break;  // return what we have rather than stall
      fs->cv_empty.wait(lk, [&] {
        return fs->stop.load() || fs->head.load() > fs->tail.load() ||
               fs->head.load() >= (int64_t)fs->hdr.nframes;
      });
      if (fs->head.load() <= fs->tail.load()) break;
    }
    size_t slot = (size_t)(t % fs->ring_cap);
    lk.unlock();
    std::memcpy(dst + (size_t)got * fs->out_bytes(), fs->ring[slot].data(),
                fs->out_bytes());
    lk.lock();
    fs->tail.store(t + 1);
    fs->cv_full.notify_all();
    ++got;
  }
  return got;
}

void fs_close(void* h) {
  auto* fs = (FrameStore*)h;
  fs->stop.store(true);
  fs->cv_full.notify_all();
  fs->cv_empty.notify_all();
  if (fs->producer.joinable()) fs->producer.join();
  if (fs->map) munmap((void*)fs->map, fs->map_size);
  if (fs->fd >= 0) ::close(fs->fd);
  delete fs;
}

// Writer utility: create an LKRAW file from a raw buffer.
int fs_write(const char* path, const uint8_t* data, uint32_t w, uint32_t hgt,
             uint32_t c, uint32_t n) {
  int fd = ::open(path, O_CREAT | O_TRUNC | O_WRONLY, 0644);
  if (fd < 0) return -1;
  Header hdr;
  std::memcpy(hdr.magic, "LKRW", 4);
  hdr.width = w;
  hdr.height = hgt;
  hdr.channels = c;
  hdr.nframes = n;
  if (::write(fd, &hdr, sizeof(hdr)) != (ssize_t)sizeof(hdr)) {
    ::close(fd);
    return -1;
  }
  size_t total = (size_t)w * hgt * c * n;
  size_t off = 0;
  while (off < total) {
    ssize_t k = ::write(fd, data + off, total - off);
    if (k <= 0) { ::close(fd); return -1; }
    off += (size_t)k;
  }
  ::close(fd);
  return 0;
}

}  // extern "C"
