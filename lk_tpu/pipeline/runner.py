"""Frame-chunk scanning and the host-facing video pipeline driver.

The reference processes one frame per Python-loop iteration with ~10
Python<->C++ crossings (SURVEY.md §3.1); here a chunk of T frames is one
``lax.scan`` inside one jit — the host only feeds raw frame batches and
drains per-chunk outputs.  Batching over independent streams is a leading
vmap axis (SURVEY.md §2.5: streams are the natural data-parallel axis).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from lk_tpu.config import PipelineConfig
from lk_tpu.ops.rasterize import build_roi_masks
from lk_tpu.pipeline.state import (
    CompactChunkOutputs,
    FrameOutputs,
    PipelineState,
    init_pipeline_state,
)
from lk_tpu.pipeline.step import make_step, preprocess_frame


import functools


@functools.lru_cache(maxsize=32)
def _cached_runner(cfg: PipelineConfig, frame_size: Tuple[int, int]):
    """One compiled runner per (config, geometry) — N same-shape streams
    (the serving case) share a single executable instead of re-jitting
    per VideoPipeline instance."""
    run_chunk, init_fn, masks = make_chunk_runner(cfg, frame_size)
    import jax as _jax

    return _jax.jit(run_chunk), _jax.jit(init_fn), masks


@functools.lru_cache(maxsize=32)
def _cached_preprocess(cfg: PipelineConfig, out_h: int, out_w: int):
    import jax as _jax

    return _jax.jit(lambda f: preprocess_frame(f, cfg, out_h, out_w))


@functools.lru_cache(maxsize=32)
def _cached_finish(cfg: PipelineConfig):
    import jax as _jax

    from lk_tpu.ops.blur import gaussian_blur3
    from lk_tpu.ops.tone import contrast_brightness

    def _finish(g):
        g = g.astype(jnp.float32)
        if cfg.contrast_enhance:
            g = contrast_brightness(g)
        return gaussian_blur3(g)

    return _jax.jit(_jax.vmap(_finish))


def _compact_masked_rows(rows: jnp.ndarray, mask: jnp.ndarray, cap: int):
    """Order-stable device compaction of (..., T, P, 2) masked rows.

    Sorts each chunk's T*P slots by flat (frame, slot) index among the
    masked entries (unmasked keys sort past the end), carrying the x/y
    coordinates as sort payload — an exact, order-stable permutation with
    zero gathers.  Returns
    ((..., cap, 2) rows, (..., T) exact per-frame counts); rows beyond cap
    are lost on device, which the host detects from the counts.
    """
    t, p = mask.shape[-2:]
    n = t * p
    cap = min(cap, n)
    flat_m = mask.reshape(mask.shape[:-2] + (n,))
    idx = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(flat_m, idx, jnp.int32(n))
    flat_r = rows.reshape(rows.shape[:-3] + (n, 2))
    _, xs, ys = jax.lax.sort(
        (key, flat_r[..., 0], flat_r[..., 1]), num_keys=1
    )
    comp = jnp.stack([xs[..., :cap], ys[..., :cap]], axis=-1)
    counts = jnp.sum(mask, axis=-1).astype(jnp.int32)
    return comp, counts


def _compact_chunk_outputs(outs: FrameOutputs,
                           cap_per_frame: int) -> CompactChunkOutputs:
    """FrameOutputs -> CompactChunkOutputs with a T*cap_per_frame budget.

    Expects leaves laid out (..., T, per-frame-axes): (T, ...) from the
    single-stream runner, (B, T, ...) from the batched runner after its
    host-layout transpose."""
    t = outs.show_mask.shape[-1]
    cap = cap_per_frame * t
    upd_rows, upd_counts = _compact_masked_rows(
        outs.update_rows, outs.update_mask, cap)
    cp_rows, cp_counts = _compact_masked_rows(
        outs.cp_xy, outs.cp_mask, cap)
    empty_rows = jnp.zeros(outs.update_rows.shape[:-2] + (0, 2), jnp.float32)
    empty_mask = jnp.zeros(outs.update_mask.shape[:-1] + (0,), jnp.bool_)
    # pts/pts_valid/motion_labels are overlay-API surface with no drain
    # consumer — drop them from the capped transport too (grep-verified)
    lead = outs.pts.shape[:-3]
    rest = outs._replace(
        update_rows=empty_rows, update_mask=empty_mask,
        cp_xy=empty_rows, cp_mask=empty_mask,
        pts=jnp.zeros(lead + (0, 0, 2), jnp.float32),
        pts_valid=jnp.zeros(lead + (0, 0), jnp.bool_),
        motion_labels=jnp.zeros(outs.motion_labels.shape[:-1] + (0,),
                                jnp.int32),
    )
    return CompactChunkOutputs(
        upd_rows=upd_rows, upd_counts=upd_counts,
        cp_rows=cp_rows, cp_counts=cp_counts, rest=rest,
    )


def make_chunk_runner(cfg: PipelineConfig, frame_size: Tuple[int, int]):
    """Returns (run_chunk, init_fn, masks) for processed-gray frame chunks.

    run_chunk(state, frames (T, H, W)) -> (state, FrameOutputs stacked on T).
    init_fn(first_gray) -> PipelineState with the initial detection applied
    (reference LK_Final.py:481-492 detects on the first frame before looping).
    """
    width, height = frame_size
    roi_mask, sub_masks = build_roi_masks(width, height, cfg.roi)
    step, detect, _ = make_step(cfg, frame_size, roi_mask, sub_masks)

    def run_chunk(state: PipelineState, frames: jnp.ndarray):
        state, outs = jax.lax.scan(step, state, frames)
        if cfg.out_cap > 0:
            outs = _compact_chunk_outputs(outs, cfg.out_cap)
        return state, outs

    def init_fn(first_gray: jnp.ndarray) -> PipelineState:
        st = init_pipeline_state(first_gray, cfg)
        pts, valid = detect(first_gray.astype(jnp.float32))
        return st._replace(pts=pts, valid=valid)

    return run_chunk, init_fn, (roi_mask, sub_masks)


def make_batched_chunk_runner(cfg: PipelineConfig, frame_size: Tuple[int, int]):
    """Batched-over-streams chunk runner (see step.make_step step_batched).

    run_chunk_b(states, frames (B, T, H, W)) -> (states, FrameOutputs with
    leading (B, T)).  Scans TIME with the whole stream batch inside each
    step — not vmap-of-scan, which would turn per-stream window reads into
    per-point slices and run both branches of every lax.cond.
    """
    width, height = frame_size
    roi_mask, sub_masks = build_roi_masks(width, height, cfg.roi)
    _, detect, step_batched = make_step(cfg, frame_size, roi_mask, sub_masks)

    def run_chunk_b(states: PipelineState, frames: jnp.ndarray):
        from lk_tpu.flow.sparse import fold_tracking_levels
        from lk_tpu.pipeline.step import tracker_row_band

        # seed the tracker-prep carry from the last chunk's final frame;
        # inside the scan each frame batch is prepped exactly once (and,
        # with track_row_band, cropped to the ROI's row band — the SAME
        # band step_batched's tracker was built with)
        prev_folded = fold_tracking_levels(
            states.prev_gray, cfg.lk,
            row_band=tracker_row_band(cfg, height, sub_masks))
        (states, _), outs = jax.lax.scan(
            step_batched, (states, prev_folded), jnp.swapaxes(frames, 0, 1)
        )
        # scan stacks outputs on T first; hosts consume (B, T, ...)
        outs = jax.tree_util.tree_map(
            lambda x: jnp.swapaxes(x, 0, 1), outs
        )
        if cfg.out_cap > 0:
            outs = _compact_chunk_outputs(outs, cfg.out_cap)
        return states, outs

    def init_fn(first_gray: jnp.ndarray) -> PipelineState:
        st = init_pipeline_state(first_gray, cfg)
        pts, valid = detect(first_gray.astype(jnp.float32))
        return st._replace(pts=pts, valid=valid)

    return run_chunk_b, jax.vmap(init_fn), (roi_mask, sub_masks)


class VideoPipeline:
    """Host driver: feeds frames, drains CSV rows — the ``Run()`` equivalent.

    Mirrors the reference's observable outputs: ``csv_rows`` reproduces
    vps_<video>.csv (row per VP update + row per shown frame,
    LK_Final.py:612-614,637-638,722), ``segments`` collects accepted flow
    lines (the line_segments.pkl content, LK_Final.py:375-377,559).
    """

    def __init__(
        self,
        cfg: PipelineConfig,
        src_size: Tuple[int, int],          # (W, H) of raw frames
        chunk: int = 8,
        host_preprocess: bool = False,
    ):
        self.cfg = cfg
        self.src_w, self.src_h = src_size
        self.height = cfg.derived_height(self.src_h, self.src_w)
        self.width = cfg.width
        self.chunk = chunk
        # host_preprocess: convert+resize on the host and upload small u8
        # grays instead of raw BGR — 6.7x less host->device traffic, and a
        # u8-rounded resize exactly like the reference's cv2 path
        # (io.staging reproduces cv2 bit for bit).
        self.host_preprocess = host_preprocess
        self._run_jit, self.init_fn, self.masks = _cached_runner(
            cfg, (self.width, self.height)
        )
        self._pre_jit = _cached_preprocess(cfg, self.height, self.width)
        self._finish_jit = _cached_finish(cfg)
        self.state: Optional[PipelineState] = None
        self.csv_rows: List[Tuple[float, float]] = []
        self.segments: List[dict] = []
        self.cross_points: List[Tuple[float, float]] = []
        self.motion_rows: List[Tuple[float, ...]] = []
        self.vp_per_frame: List[Optional[Tuple[float, float]]] = []
        self.frames_done = 0
        # True once the first fed frame was used for initialization (fresh
        # runs); resumed runs process every fed frame (overlay alignment).
        self.consumed_init_frame = False
        self._pending_resume: Optional[str] = None
        self.last_prefetcher = None  # set by run(prefetch>0)
        self._pending_outs: List[FrameOutputs] = []
        # chunks buffered before a host readback: drains synchronize and
        # stall feeding on bookkeeping, so buffer generously (~5 MB/chunk
        # of device memory at B=64)
        self.drain_every = 16

    def drain(self) -> None:
        """Flush buffered per-chunk outputs to the host sinks.

        All pending chunks fetch in ONE device_get, and infrequently: the
        fetch synchronizes AND the host bookkeeping that follows stalls
        feeding, so each drain idles the device (device_get already
        batches the whole pytree; the drain cadence is what matters)."""
        for outs in jax.device_get(self._pending_outs):
            self._drain(outs)
        self._pending_outs.clear()

    def resume_from(self, path: str) -> None:
        """Restore pipeline state from a checkpoint on the next feed()."""
        self._pending_resume = path

    def _ckpt_meta(self) -> str:
        """Identity string tying a checkpoint to this pipeline's config."""
        return f"{self.width}x{self.height}|{self.cfg!r}"

    def save_checkpoint(self, path: str) -> str:
        from lk_tpu.utils.checkpoint import save_state

        if self.state is None:
            raise RuntimeError("no state to checkpoint yet")
        return save_state(self.state, path, meta=self._ckpt_meta())

    def _ingest(self, frames_u8: np.ndarray) -> jnp.ndarray:
        if self.host_preprocess:
            from lk_tpu.io.staging import stage_gray

            grays = np.empty(
                (len(frames_u8), self.height, self.width), np.uint8
            )
            for k, f in enumerate(frames_u8):
                grays[k] = stage_gray(np.asarray(f), self.width, self.height)
            return self._finish_jit(jnp.asarray(grays))
        x = jnp.asarray(frames_u8)
        return jax.vmap(self._pre_jit)(x) if x.ndim == 4 else self._pre_jit(x)

    def feed(self, frames_u8: np.ndarray) -> FrameOutputs:
        """Process (T, Hs, Ws, 3) u8 BGR frames; returns stacked outputs."""
        return self.feed_gray(self._ingest(frames_u8))

    def feed_gray(self, grays: jnp.ndarray) -> FrameOutputs:
        """Process already-ingested (T, H, W) float32 gray frames
        (the async-prefetch path runs ``_ingest`` on the producer thread)."""
        if self.state is None:
            if self._pending_resume is not None:
                # Restore the full state (incl. prev_gray): every fed frame
                # is then processed — none is consumed for initialization.
                # init_pipeline_state is shape-only (no detection dispatch);
                # load_state overwrites all leaves anyway.
                from lk_tpu.utils.checkpoint import load_state

                template = init_pipeline_state(grays[0], self.cfg)
                self.state = load_state(
                    template, self._pending_resume, meta=self._ckpt_meta()
                )
                self._pending_resume = None
            else:
                self.state = self.init_fn(grays[0])
                self.consumed_init_frame = True
                grays = grays[1:]
                if grays.shape[0] == 0:
                    return None
        self.state, outs = self._run_jit(self.state, grays)
        # Defer the device->host fetch: dispatch is async, so stashing the
        # handles lets the next chunk's compute overlap this chunk's readback.
        self._pending_outs.append(outs)
        if len(self._pending_outs) >= self.drain_every:
            self.drain()
        return outs

    def _drain(self, outs, n_valid: Optional[int] = None) -> None:
        # One device->host transfer for the whole pytree (per-array fetches
        # would each synchronize).  The bookkeeping below is vectorized
        # numpy, not a per-frame Python loop.
        #
        # n_valid: only the first n_valid frames of the chunk belong to this
        # stream (ragged lifecycles — MultiStreamPipeline keeps feeding a
        # finished slot padding frames until it is recycled; their outputs
        # are dropped here, exactly).
        outs = jax.device_get(outs)
        compact = isinstance(outs, CompactChunkOutputs)
        if compact:
            comp, outs = outs, outs.rest
        t = outs.show_mask.shape[0]
        nv = t if n_valid is None else max(0, min(int(n_valid), t))
        if nv == 0:
            return
        show_rows = np.asarray(outs.show_row, np.float64)[:nv]
        show_mask = np.asarray(outs.show_mask)[:nv]
        seg_s = np.asarray(outs.line_start)[:nv]
        seg_e = np.asarray(outs.line_stop)[:nv]
        seg_m = np.asarray(outs.line_mask)[:nv]
        fracs = np.asarray(outs.motion_fracs)[:nv]

        if compact:
            # reconstruct the exact masked row streams from the compacted
            # buffers + per-frame counts (runner._compact_chunk_outputs);
            # rows are frame-ordered, so truncated chunks keep an exact
            # prefix and the overflow check applies to the kept frames
            cap = comp.upd_rows.shape[-2]
            upd_counts = np.asarray(comp.upd_counts, np.int64)[:nv]
            cp_counts = np.asarray(comp.cp_counts, np.int64)[:nv]
            n_upd = int(upd_counts.sum())
            n_cp = int(cp_counts.sum())
            if n_upd > cap or n_cp > cap:
                raise RuntimeError(
                    f"output compaction overflow: chunk emitted "
                    f"{max(n_upd, n_cp)} rows > budget {cap}; raise "
                    f"PipelineConfig.out_cap (or set 0 to disable)"
                )
            upd_rows = np.asarray(comp.upd_rows, np.float64)[:n_upd]
            cp_rows = np.asarray(comp.cp_rows, np.float64)[:n_cp]
            upd_frame = np.repeat(np.arange(nv), upd_counts)
        else:
            upd_full = np.asarray(outs.update_rows, np.float64)[:nv]
            upd_m = np.asarray(outs.update_mask)[:nv]
            cp_full = np.asarray(outs.cp_xy, np.float64)[:nv]
            cp_m = np.asarray(outs.cp_mask)[:nv]
            upd_rows = upd_full[upd_m]
            cp_rows = cp_full[cp_m]
            upd_frame = np.nonzero(upd_m)[0]

        self.motion_rows.extend(map(tuple, np.round(fracs, 4)))
        self.cross_points.extend(map(tuple, cp_rows))
        # csv rows: per frame, update rows (in order) then the show row —
        # the reference emission order (LK_Final.py:612-638).  A stable
        # sort on (frame, kind) interleaves the two compacted streams.
        if self.cfg.csv_rows_on_update:
            show_frame = np.nonzero(show_mask)[0]
            allr = np.concatenate([upd_rows, show_rows[show_mask]], axis=0)
            key = np.concatenate([upd_frame * 2, show_frame * 2 + 1])
            self.csv_rows.extend(map(tuple, allr[np.argsort(key,
                                                            kind="stable")]))
        else:
            self.csv_rows.extend(map(tuple, show_rows[show_mask]))
        self.vp_per_frame.extend(
            tuple(r) if m else None for r, m in zip(show_rows, show_mask)
        )
        self.segments.extend(
            dict(start=a.copy(), stop=b.copy())
            for a, b in zip(seg_s[seg_m], seg_e[seg_m])
        )
        self.frames_done += nv

    def run(self, frames: Iterable[np.ndarray], prefetch: int = 0) -> None:
        """Consume an iterable of single (Hs, Ws, 3) u8 frames in chunks.

        ``prefetch > 0`` decodes and preprocesses ``prefetch`` chunks ahead
        on a producer thread (lk_tpu.io.prefetch), overlapping host decode
        with device compute — the replacement for the reference's
        synchronous ``cap.read()`` loop (LK_Final.py:509-517).
        """
        if prefetch > 0:
            from lk_tpu.io.prefetch import ChunkPrefetcher

            pf = ChunkPrefetcher(
                frames, self.chunk, depth=prefetch, transform=self._ingest
            )
            self.last_prefetcher = pf  # overlap evidence for profiling/tests
            try:
                for grays in pf:
                    self.feed_gray(grays)
            finally:
                pf.close()
            self.drain()
            return
        buf: List[np.ndarray] = []
        for f in frames:
            buf.append(f)
            if len(buf) == self.chunk + (1 if self.state is None else 0):
                self.feed(np.stack(buf))
                buf.clear()
        if buf:
            self.feed(np.stack(buf))
        self.drain()


@functools.lru_cache(maxsize=16)
def _cached_batched_runner(cfg: PipelineConfig, frame_size: Tuple[int, int],
                           mesh=None, mesh_axis: str = "streams"):
    """jit (or shard_map over ``mesh_axis``) of the batched chunk runner.

    With a mesh, the PRODUCTION batched step (step_batched — frame-band
    window gathers, fold carry, detection gated on any(trigger)) runs
    per-shard on B/D local streams: streams are embarrassingly parallel
    (SURVEY.md §2.5), so each device executes exactly the single-device
    program at a smaller batch — no collectives.
    The any(trigger) detection gate becomes per-shard, which only ever
    *skips more* work (a shard with no triggering stream takes the zero
    branch; non-triggering streams discard det outputs either way)."""
    run_chunk_b, init_b, _ = make_batched_chunk_runner(cfg, frame_size)
    if mesh is None:
        return jax.jit(run_chunk_b), jax.jit(init_b)
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    lead = P(mesh_axis)
    run_s = shard_map(
        run_chunk_b, mesh=mesh, in_specs=(lead, lead),
        out_specs=(lead, lead), check_vma=False,
    )
    init_s = shard_map(
        init_b, mesh=mesh, in_specs=(lead,), out_specs=lead, check_vma=False,
    )
    return jax.jit(run_s), jax.jit(init_s)


@functools.lru_cache(maxsize=1)
def _cached_slot_swap():
    """jit of: overwrite batch slot b of a batched state pytree with a fresh
    single-stream state (slot recycling — b is traced, so one executable
    serves every slot index)."""

    def swap(states, fresh, b):
        return jax.tree_util.tree_map(
            lambda s, f: jax.lax.dynamic_update_index_in_dim(s, f, b, 0),
            states, fresh,
        )

    return jax.jit(swap)


@functools.lru_cache(maxsize=64)
def _cached_staged_feed(cfg: PipelineConfig, frame_size: Tuple[int, int],
                        n: int, mesh=None, mesh_axis: str = "streams",
                        src_hw: Optional[Tuple[int, int]] = None):
    """ONE jit for a staged serving feed iteration: dynamic-slice n frame
    batches out of a time-major (F, B, H, W) u8 staging array, finish
    (u8->f32 [+tone] + blur) and run the chunk scan — no intermediate
    dispatches (the (F, B) layout also makes the chunk slice contiguous
    and lets XLA cancel the scan's (B,T)->(T,B) swap).

    src_hw: staging holds SOURCE-resolution u8 grays (e.g. 1080x1920) and
    the reference's fixed-width INTER_AREA resize (LK_Final.py:429,517 via
    imutils) runs ON DEVICE inside this same dispatch, before finish — the
    end-to-end serving form where the 1080p->processing-size preprocess is
    device work in the timed window (BASELINE config #5's stated geometry).

    With a mesh, the WHOLE staged iteration (slice + finish + chunk scan)
    shard_maps over ``mesh_axis``: staging stays sharded on its stream
    axis (spec (None, streams)) so no frame bytes cross devices."""
    from lk_tpu.ops.resize import resize_area

    run_b, _ = _cached_batched_runner(cfg, frame_size)
    finish = _cached_finish(cfg)
    w, h = frame_size
    sh_, sw_ = src_hw if src_hw is not None else (h, w)

    def staged(states, staging_fb, t):
        c = jax.lax.dynamic_slice_in_dim(staging_fb, t, n, 0)  # (n,B,hs,ws)
        b = c.shape[1]
        g = c.reshape(n * b, sh_, sw_)
        if src_hw is not None:
            g = resize_area(g, h, w)      # two matmuls, f32 HIGHEST
        g = finish(g).reshape(n, b, h, w)
        return run_b(states, jnp.swapaxes(g, 0, 1))

    if mesh is None:
        return jax.jit(staged)
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    lead = P(mesh_axis)
    return jax.jit(shard_map(
        staged, mesh=mesh,
        in_specs=(lead, P(None, mesh_axis), P()),
        out_specs=(lead, lead), check_vma=False,
    ))


class MultiStreamPipeline:
    """B same-geometry streams batched through ONE on-device pipeline step.

    The reference runs one video per process (reference LK_Final.py:778-780);
    single-device serving batches the full VP-pipeline chunk scan over a
    leading stream axis, so the 20-point tracker/geometry work — far too
    small to fill an accelerator per stream — runs for all streams in the
    same kernels.  Per-stream host bookkeeping (CSV rows, segments, VP
    trajectories) is delegated to B :class:`VideoPipeline` sinks.

    Feed either raw frames (``feed``) or preprocessed grayscale
    (``feed_processed`` — the serving hot path, with decode/preprocess
    handled upstream by lk_tpu.io).
    """

    def __init__(
        self,
        cfg: PipelineConfig,
        src_size: Tuple[int, int],
        n_streams: int,
        chunk: int = 16,
        host_preprocess: bool = True,
        mesh=None,
        mesh_axis: str = "streams",
    ):
        self.cfg = cfg
        self.n_streams = n_streams
        self.chunk = chunk
        self.src_size = src_size
        self.host_preprocess = host_preprocess
        # mesh: shard the stream batch over ``mesh_axis`` of a
        # jax.sharding.Mesh — each device runs the identical single-device
        # serving program on its B/D local streams (zero collectives; see
        # _cached_batched_runner).  Host-side sinks/drains are unchanged:
        # outputs come back as global arrays.
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        if mesh is not None and n_streams % mesh.shape[mesh_axis] != 0:
            raise ValueError(
                f"n_streams={n_streams} not divisible by mesh axis "
                f"{mesh_axis!r} size {mesh.shape[mesh_axis]}"
            )
        self.pipes = [
            VideoPipeline(cfg, src_size=src_size, chunk=chunk,
                          host_preprocess=host_preprocess)
            for _ in range(n_streams)
        ]
        self.width = self.pipes[0].width
        self.height = self.pipes[0].height
        self._vrun, self._vinit = _cached_batched_runner(
            cfg, (self.width, self.height), mesh, mesh_axis
        )
        self.states = None
        # pending entries: (chunk outputs, per-slot n_valid | None, sinks)
        self._pending: List[tuple] = []
        self.drain_every = 16
        self._drain_worker = None
        self._drain_q = None
        # Ragged lifecycles: real fleets have streams that end and get
        # replaced mid-batch.  A finished slot keeps being scanned with
        # whatever padding frames the caller stages (its on-device state
        # evolves garbage — harmless, no cross-slot coupling in the batched
        # step) but its outputs are dropped exactly at the drain via the
        # per-chunk n_valid counts; assign_stream swaps a fresh init state
        # into the slot on device and retires the old sink.
        self.active = np.ones(n_streams, dtype=bool)
        self.retired: List[VideoPipeline] = []

    def finish_stream(self, b: int) -> None:
        """Mark slot ``b`` ended: subsequent chunks drop its outputs (the
        caller passes ``n_valid`` for the chunk in which it ends, if that
        end is not chunk-aligned).  The slot's sink stays readable until
        :meth:`assign_stream` recycles it."""
        self.active[b] = False

    def assign_stream(self, b: int, first_gray: jnp.ndarray) -> VideoPipeline:
        """Recycle slot ``b`` for a new stream whose first processed gray
        frame is ``first_gray`` (consumed for initialization, like the
        reference's first-frame detection — LK_Final.py:481-492).  The old
        sink moves to ``self.retired``; returns the fresh sink."""
        if self.states is None:
            raise RuntimeError("assign_stream before the first feed")
        self.retired.append(self.pipes[b])
        p = VideoPipeline(self.cfg, src_size=self.src_size, chunk=self.chunk,
                          host_preprocess=self.host_preprocess)
        p.consumed_init_frame = True
        self.pipes[b] = p
        fresh = p.init_fn(jnp.asarray(first_gray, jnp.float32))
        self.states = _cached_slot_swap()(self.states, fresh, jnp.int32(b))
        self.active[b] = True
        return p

    def _chunk_valid(self, t: int, n_valid) -> Optional[np.ndarray]:
        """Per-slot valid-frame counts for a t-frame chunk: explicit
        ``n_valid`` wins; otherwise active slots own the whole chunk."""
        if n_valid is not None:
            nv = np.asarray(n_valid, np.int64).copy()
            assert nv.shape == (self.n_streams,)
            return nv
        if self.active.all():
            return None                      # fast path: nothing to trim
        return np.where(self.active, t, 0).astype(np.int64)

    def start_async_drains(self) -> None:
        """Move readback + bookkeeping to a worker thread so periodic
        drains no longer stall feeding (the fetch synchronizes on the
        device AND the per-stream numpy bookkeeping runs while the next
        chunks could be dispatching).  Call ``drain()`` at end-of-stream
        as usual — it flushes the queue and joins in-flight work."""
        import queue
        import threading

        if self._drain_worker is not None:
            return
        self._drain_q = queue.Queue(maxsize=4)
        self._drain_err = None

        def work():
            while True:
                item = self._drain_q.get()
                try:
                    if item is None:
                        return
                    self._drain_now(item)
                except BaseException as e:  # surfaced at the next drain()
                    self._drain_err = e
                finally:
                    self._drain_q.task_done()

        self._drain_worker = threading.Thread(
            target=work, name="lk-drain", daemon=True
        )
        self._drain_worker.start()

    def feed(self, batch: np.ndarray, n_valid=None) -> None:
        """batch: (B, T, Hs, Ws, 3) u8 BGR frames, one row per stream."""
        grays = jnp.stack([
            p._ingest(batch[b]) for b, p in enumerate(self.pipes)
        ])
        self.feed_processed(grays, n_valid=n_valid)

    def feed_processed(self, grays: jnp.ndarray, n_valid=None) -> None:
        """grays: (B, T, H, W) preprocessed float32 frames.

        ``n_valid``: optional (B,) leading-valid-frame counts for THIS
        chunk's *processed* frames (streams ending mid-chunk keep exactly
        their first n_valid outputs; the consumed init frame, if any, is
        not counted).  Defaults to the full chunk for active slots, 0 for
        finished ones."""
        assert grays.shape[0] == self.n_streams
        if self.states is None:
            self.states = self._vinit(grays[:, 0])
            for p in self.pipes:
                p.consumed_init_frame = True
            grays = grays[:, 1:]
            if grays.shape[1] == 0:
                return
        self.states, outs = self._vrun(self.states, grays)
        # Defer readback (async dispatch): drain fetches the whole batched
        # pytree in one device->host transfer, then slices per stream.
        # The sink-list snapshot rides along so a later assign_stream can't
        # steal this chunk's rows from the sink that owned the slot.
        self._pending.append((outs, self._chunk_valid(grays.shape[1],
                                                      n_valid),
                              list(self.pipes)))
        if len(self._pending) >= self.drain_every:
            self._drain_enqueue()

    def feed_staged(self, staging_fb: jnp.ndarray, t: int, n: int,
                    n_valid=None) -> None:
        """Process frames [t, t+n) of a TIME-MAJOR (F, B, H, W) u8 device
        staging array: slice + finish + chunk scan run as ONE dispatch
        (see _cached_staged_feed).  The u8 layout keeps device staging 4x
        smaller than f32 and the time-major axis makes the slice
        contiguous.  First call consumes one frame for initialization.

        Staging at the processing size (H, W) == (height, width) feeds
        directly; staging at SOURCE resolution (e.g. 1080x1920 grays)
        additionally runs the reference's fixed-width INTER_AREA resize
        (LK_Final.py:429,517) on device inside the same dispatch — the
        BASELINE-config-#5 serving form with preprocess in the timed
        window.  ``n_valid`` as in :meth:`feed_processed`."""
        assert staging_fb.shape[1] == self.n_streams
        src_hw = tuple(int(d) for d in staging_fb.shape[2:])
        if src_hw == (self.height, self.width):
            src_hw = None
        if self.states is None:
            first = staging_fb[t]
            if src_hw is not None:
                from lk_tpu.ops.resize import resize_area

                first = resize_area(first, self.height, self.width)
            self.states = self._vinit(self._finish(first))
            for p in self.pipes:
                p.consumed_init_frame = True
            t += 1
            n -= 1
            if n == 0:
                return
        fn = _cached_staged_feed(
            self.cfg, (self.width, self.height), n, self.mesh,
            self.mesh_axis, src_hw)
        self.states, outs = fn(self.states, staging_fb, t)
        self._pending.append((outs, self._chunk_valid(n, n_valid),
                              list(self.pipes)))
        if len(self._pending) >= self.drain_every:
            self._drain_enqueue()

    def _finish(self, grays_u8: jnp.ndarray) -> jnp.ndarray:
        return self.pipes[0]._finish_jit(grays_u8)

    @property
    def staging_sharding(self):
        """Sharding to device_put the (F, B, H, W) staging array with in
        mesh mode (stream axis sharded, frames replicated per shard — the
        layout _cached_staged_feed's shard_map expects, so staging bytes
        land on their owning device once and never cross devices).  ``None``
        without a mesh."""
        if self.mesh is None:
            return None
        from jax.sharding import NamedSharding, PartitionSpec as P

        return NamedSharding(self.mesh, P(None, self.mesh_axis))

    def drain(self) -> None:
        # one device->host fetch for every pending chunk of every stream;
        # infrequent by default — each drain synchronizes and then stalls
        # feeding on host bookkeeping (see VideoPipeline.drain).  With
        # start_async_drains, periodic drains enqueue to the worker and a
        # final drain() flushes it.
        pending, self._pending = self._pending, []
        if self._drain_q is not None:
            self._drain_q.put(pending)
            self._drain_q.join()      # final flush: wait for bookkeeping
            self._raise_drain_err()
            return
        self._drain_now(pending)

    def _raise_drain_err(self) -> None:
        if getattr(self, "_drain_err", None) is not None:
            err, self._drain_err = self._drain_err, None
            raise err

    def _drain_enqueue(self) -> None:
        pending, self._pending = self._pending, []
        if self._drain_q is not None:
            self._raise_drain_err()       # fail fast, don't fill the queue
            self._drain_q.put(pending)    # worker fetches + bookkeeps
        else:
            self._drain_now(pending)

    def _drain_now(self, pending) -> None:
        hosts = jax.device_get([outs for outs, _, _ in pending])
        for host, (_, nv, pipes) in zip(hosts, pending):
            for b, p in enumerate(pipes):
                p._drain(
                    jax.tree_util.tree_map(lambda x: x[b], host),
                    n_valid=None if nv is None else int(nv[b]),
                )

    @property
    def frames_done(self) -> int:
        return sum(p.frames_done for p in self.pipes) + sum(
            p.frames_done for p in self.retired)
