"""lk.serve — multi-stream VP-pipeline serving benchmark.

Runs N concurrent dashcam streams batched through ONE on-device pipeline
step (pipeline.runner.MultiStreamPipeline): the full VP pipeline — tracker,
flow-line geometry, cross points, VP state machine — executes for all
streams inside the same ``lax.scan``.  This is the single-device serving
model; across devices, stream batches shard over a mesh axis with zero
collectives (MultiStreamPipeline's ``mesh``).

The timed window measures the pipeline with frames pre-staged as processed
grayscale on the device (decode/ingest engineered separately in lk_tpu.io;
its throughput is a host property, not a device property).  Output drains
(device->host fetch + CSV bookkeeping) are inside the timed window.

Usage: python -m lk_tpu.apps.serve --streams 32 --frames 64
"""

from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from lk_tpu.config import PipelineConfig
from lk_tpu.io.staging import resize_area_u8
from lk_tpu.io.video import SyntheticRoadStream
from lk_tpu.pipeline.runner import MultiStreamPipeline
from lk_tpu.utils import enable_compilation_cache


class ServeRun(NamedTuple):
    fps: float                    # aggregate frames/s over the timed window
    wall_s: float                 # timed seconds
    server: MultiStreamPipeline   # per-stream sinks in server.pipes


def scene(args, s: int) -> SyntheticRoadStream:
    """Stream ``s``'s seeded synthetic source (gray frames)."""
    return SyntheticRoadStream(width=args.width, height=args.height,
                               n_frames=args.frames, seed=s, color=False,
                               vp=(args.width * (0.45 + 0.01 * (s % 5)),
                                   args.height * 0.45))


def stage_u8(scenes, frames: int, height: int, width: int) -> np.ndarray:
    """Time-major (F, B, height, width) u8 staging of the scenes' gray
    frames, INTER_AREA-resized when the geometry differs (host threads,
    one per stream)."""
    out = np.empty((frames, len(scenes), height, width), np.uint8)

    def one(b):
        for t in range(frames):
            g = scenes[b].frame_gray(t)
            out[t, b] = (g if g.shape == (height, width)
                         else resize_area_u8(g, width, height))

    with ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(one, range(len(scenes))))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--streams", type=int, default=32)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--drain-every", type=int, default=16,
                   help="chunks buffered on device before one host readback")
    p.add_argument("--async-drains", action="store_true",
                   help="readback + bookkeeping on a worker thread (frees "
                        "the feed thread where bookkeeping CPU matters)")
    p.add_argument("--live-ingest", action="store_true",
                   help="decode per stream on producer threads during the "
                        "timed window (io.prefetch.MultiStreamPrefetcher) "
                        "instead of pre-staging clips in device memory — "
                        "end-to-end serving incl. decode overlap")
    p.add_argument("--device-preprocess", action="store_true",
                   help="stage u8 grays at SOURCE resolution and run the "
                        "reference's fixed-width INTER_AREA resize "
                        "(LK_Final.py:429,517) ON DEVICE inside the timed "
                        "window — BASELINE config #5's stated geometry "
                        "(e.g. --width 1920 --height 1080).  Watch device "
                        "memory: staging is F*B*H*W bytes")
    p.add_argument("--stage-window", type=int, default=0,
                   help="frames per staged device window (0 = stage the "
                        "whole run).  Large source-resolution staging "
                        "(1080p at B=64 x 192 frames is 25.5 GB) re-stages "
                        "in windows: upload UNTIMED between timed windows, "
                        "each timed window ends with its drain (the sync "
                        "point)")
    p.add_argument("--preset", default="final",
                   choices=("final", "vp_detect", "classify"),
                   help="pipeline preset (models.PRESETS); 'classify' is "
                        "the LK3 motion-classification configuration "
                        "BASELINE config #5 names")
    p.add_argument("--out-cap", type=int, default=48,
                   help="per-frame average budget for the device-side "
                        "output-row compaction (PipelineConfig.out_cap); "
                        "0 transports the full 190-slot padding")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> ServeRun:
    args = build_parser().parse_args(argv)
    enable_compilation_cache()

    import dataclasses

    from lk_tpu.models import PRESETS

    # out_cap: compact the update/CP row transport on device (exact, counts
    # checked on drain): 48/frame avg per 16-frame chunk = 768-row budget
    # vs p99 ~100 peaks on single frames, mean ~14.
    cfg = dataclasses.replace(PRESETS[args.preset], out_cap=args.out_cap)
    scenes = [scene(args, s) for s in range(args.streams)]

    server = MultiStreamPipeline(cfg, src_size=(args.width, args.height),
                                 n_streams=args.streams, chunk=args.chunk)
    server.drain_every = args.drain_every
    if args.async_drains:
        server.start_async_drains()
    # Warm/compile untimed: one full pass through a throwaway server with
    # every chunk shape feed() will see (chunk+1 leading, trailing partial).
    warm = MultiStreamPipeline(cfg, src_size=(args.width, args.height),
                               n_streams=args.streams, chunk=args.chunk)
    warm.drain_every = args.drain_every

    if args.live_ingest:
        # decode + upload + pipeline all overlap; warm with the same path
        _feed_live(warm, scenes, args)
        warm.drain()
        t0 = time.time()
        decode_busy = _feed_live(server, scenes, args)
        server.drain()
        dt = time.time() - t0
    else:
        # Pre-stage grays on device as u8 (untimed): decode+resize is the
        # io subsystem's job and exercised by --live-ingest.  u8 staging is
        # 4x smaller than f32, and the finishing blur (device work any real
        # server performs) runs per chunk inside the timed window.
        # TIME-MAJOR (F, B, h, w) layout: each chunk slice is contiguous
        # and feed_staged fuses slice+finish+scan into one dispatch.  With
        # --device-preprocess the staging keeps SOURCE resolution and the
        # INTER_AREA resize runs on device inside the timed feed.
        h, w = ((args.height, args.width) if args.device_preprocess
                else (server.height, server.width))
        u8 = stage_u8(scenes, args.frames, h, w)
        decode_busy = None
        if args.stage_window:
            # windowed re-staging: see --stage-window help.  Drain cadence
            # becomes the window (each timed segment ends at a real sync).
            _feed_windowed(warm, u8, args)
            dt = _feed_windowed(server, u8, args)
        else:
            grays = jnp.asarray(u8)
            grays.block_until_ready()

            _feed_all(warm, grays, args)
            warm.drain()

            t0 = time.time()
            _feed_all(server, grays, args)
            server.drain()          # device_get inside: synchronizes
            dt = time.time() - t0

    total = server.frames_done
    ok = sum(1 for p_ in server.pipes if len(p_.csv_rows) > 0)
    agg = total / dt
    if not args.quiet:
        print(f"streams: {args.streams}  frames: {total}  wall: {dt:.2f}s")
        src = (f" from {args.width}x{args.height} source, on-device "
               f"preprocess" if args.device_preprocess else "")
        print(f"aggregate: {agg:.1f} frames/s/device "
              f"({agg / 30:.1f} x 30fps streams/device at "
              f"{server.width}x{server.height}{src})")
        if decode_busy is not None:
            print(f"decode busy (all threads): {decode_busy:.2f}s "
                  f"across {args.streams} workers — overlap "
                  f"{decode_busy / max(dt, 1e-9):.1f}x wall")
        print(f"streams with VP output: {ok}/{args.streams}")
    return ServeRun(fps=agg, wall_s=dt, server=server)


def _feed_live(server: MultiStreamPipeline, scenes, args) -> float:
    """Feed via per-stream decode threads + batched device staging; returns
    total decode-thread busy seconds (the overlap evidence)."""
    from lk_tpu.io.prefetch import MultiStreamPrefetcher

    h, w = server.height, server.width
    finish = server.pipes[0]._finish_jit

    def gray_stream(scene):
        for t in range(args.frames):
            yield resize_area_u8(scene.frame_gray(t), w, h)

    def batch_transform(u8_batch):    # (B, n, h, w) u8, coordinator thread
        b, n = u8_batch.shape[:2]
        return finish(jnp.asarray(u8_batch.reshape(b * n, h, w))).reshape(
            b, n, h, w
        )

    mp = MultiStreamPrefetcher(
        [gray_stream(s) for s in scenes], chunk=args.chunk, depth=2,
        first_extra=1, batch_transform=batch_transform,
    )
    try:
        for batch in mp:
            server.feed_processed(batch)
    finally:
        mp.close()
    return mp.decode_busy_s


def _feed_windowed(server: MultiStreamPipeline, u8, args) -> float:
    """Feed the host (F, B, h, w) u8 array in --stage-window frame windows:
    upload each window untimed, feed + drain it timed; returns summed timed
    seconds.  The per-window drain bounds the timed segment at a real device
    sync (device_get), so no dispatched work leaks into the untimed upload
    gaps."""
    timed = 0.0
    f = args.frames
    tg = 0
    while tg < f:
        n_win = min(args.stage_window, f - tg)
        g = jnp.asarray(u8[tg:tg + n_win])
        g.block_until_ready()               # upload, untimed
        t0 = time.time()
        t = 0
        while t < n_win:
            n = min(args.chunk + (1 if server.states is None else 0),
                    n_win - t)
            server.feed_staged(g, t, n)
            t += n
        server.drain()
        timed += time.time() - t0
        tg += n_win
    return timed


def _feed_all(server: MultiStreamPipeline, grays, args) -> None:
    """Feed a time-major (F, B, h, w) u8 device staging array, one fused
    dispatch per chunk (slice + finish + scan; see feed_staged)."""
    t = 0
    f = args.frames
    while t < f:
        # first feed consumes one extra frame for initialization
        n = min(args.chunk + (1 if server.states is None else 0), f - t)
        server.feed_staged(grays, t, n)
        t += n


if __name__ == "__main__":
    main()
