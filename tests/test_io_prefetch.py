"""Async ingest: decode/preprocess producer overlapped with consumption.

Replaces the reference's synchronous per-frame cap.read() loop
(LK_Final.py:509-517) with a staged producer (io/prefetch.py).  Overlap is
asserted structurally (producer finishes while the consumer still has work
queued), not by wall-clock thresholds, so the tests are load-proof.
"""

import time

import numpy as np
import pytest

from lk_tpu.io.prefetch import ChunkPrefetcher


def _frames(n, h=6, w=8, sleep=0.0):
    for t in range(n):
        if sleep:
            time.sleep(sleep)
        yield np.full((h, w, 3), t, np.uint8)


def test_chunks_and_order():
    got = list(ChunkPrefetcher(_frames(10), chunk=4))
    assert [g.shape[0] for g in got] == [4, 4, 2]
    flat = np.concatenate(got)[:, 0, 0, 0]
    np.testing.assert_array_equal(flat, np.arange(10))


def test_transform_runs_on_producer():
    tids = []

    def xf(chunk):
        import threading

        tids.append(threading.current_thread().name)
        return chunk.astype(np.float32) * 2

    got = list(ChunkPrefetcher(_frames(6), chunk=3, transform=xf))
    assert all(t == "lk-ingest" for t in tids)
    assert got[0].dtype == np.float32
    assert got[1][2, 0, 0, 0] == 10.0


def test_producer_runs_ahead_of_slow_consumer():
    """Overlap evidence: with a deep queue and a slow consumer, the producer
    finishes decoding while the consumer is still mid-stream."""
    pf = ChunkPrefetcher(_frames(12), chunk=3, depth=8)
    it = iter(pf)
    next(it)  # consumer takes one chunk ...
    time.sleep(0.3)  # ... then stalls; producer should drain the source
    assert pf.producer_done_at is not None, (
        "producer did not run ahead while the consumer stalled"
    )
    remaining = list(it)
    assert len(remaining) == 3  # 4 chunks total


def test_worker_exception_propagates():
    def bad():
        yield np.zeros((4, 4, 3), np.uint8)
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(ChunkPrefetcher(bad(), chunk=1))


def test_close_stops_producer():
    pf = ChunkPrefetcher(_frames(10_000, sleep=0.001), chunk=2, depth=2)
    next(iter(pf))
    pf.close()
    assert not pf._thread.is_alive()


def test_first_extra_chunk_sizes():
    got = list(ChunkPrefetcher(_frames(10), chunk=3, first_extra=1))
    assert [g.shape[0] for g in got] == [4, 3, 3]


class TestMultiStreamPrefetcher:
    def test_batches_match_sync_stack(self):
        from lk_tpu.io.prefetch import MultiStreamPrefetcher

        streams = [list(_frames(9, h=4, w=5)) for _ in range(3)]
        for b, s in enumerate(streams):       # make streams distinguishable
            for f in s:
                f[..., 1] = b
        got = list(MultiStreamPrefetcher(
            [iter(s) for s in streams], chunk=4, first_extra=1
        ))
        assert [g.shape[:2] for g in got] == [(3, 5), (3, 4)]
        for i, g in enumerate(got):
            for b in range(3):
                start = [0, 5][i]
                ref = np.stack(streams[b][start:start + g.shape[1]])
                np.testing.assert_array_equal(g[b], ref)

    def test_batch_transform_and_busy_accounting(self):
        from lk_tpu.io.prefetch import MultiStreamPrefetcher

        mp = MultiStreamPrefetcher(
            [_frames(6, sleep=0.002) for _ in range(2)], chunk=3,
            batch_transform=lambda b: b.astype(np.float32) + 1.0,
        )
        got = list(mp)
        assert got[0].dtype == np.float32
        assert got[0][0, 0, 0, 0, 0] == 1.0
        assert mp.decode_busy_s > 0.0

    def test_ragged_streams_truncate_to_shortest(self):
        from lk_tpu.io.prefetch import MultiStreamPrefetcher

        got = list(MultiStreamPrefetcher(
            [_frames(7), _frames(5)], chunk=3
        ))
        # chunk 0: both full (3); chunk 1: (3) vs (2) -> truncated to 2;
        # stream 2 then ends, so the 7-frame stream's tail is dropped
        assert [g.shape[:2] for g in got] == [(2, 3), (2, 2)]

    def test_close_stops_all_threads(self):
        from lk_tpu.io.prefetch import MultiStreamPrefetcher

        mp = MultiStreamPrefetcher(
            [_frames(10_000, sleep=0.001) for _ in range(2)], chunk=2,
        )
        next(iter(mp))
        mp.close()
        assert not mp._thread.is_alive()
        assert all(not p._thread.is_alive() for p in mp._pfs)


def test_pipeline_prefetch_matches_sync():
    """VideoPipeline.run(prefetch=N) == the synchronous path, row for row."""
    from lk_tpu.config import PipelineConfig
    from lk_tpu.io.video import SyntheticRoadStream
    from lk_tpu.pipeline.runner import VideoPipeline

    w, h, f = 430, 242, 13
    cfg = PipelineConfig(width=w)
    scene = SyntheticRoadStream(width=w, height=h, n_frames=f, zoom=1.03)

    sync = VideoPipeline(cfg, src_size=(w, h), chunk=4)
    sync.run(iter(scene))
    pre = VideoPipeline(cfg, src_size=(w, h), chunk=4)
    pre.run(iter(scene), prefetch=3)

    assert pre.frames_done == sync.frames_done
    assert len(pre.csv_rows) == len(sync.csv_rows)
    np.testing.assert_allclose(
        np.array(pre.csv_rows, np.float64).reshape(-1, 2),
        np.array(sync.csv_rows, np.float64).reshape(-1, 2),
        atol=1e-4,
    )
    assert len(pre.segments) == len(sync.segments)
    assert pre.last_prefetcher is not None
