"""Dense pyramidal Lucas–Kanade optical flow.

The reference only ever tracks ~20 sparse points (reference LK_Final.py:26,
531-532); this module computes the same pyramidal LK solution *densely* —
every pixel is a window center — as pure stencil/elementwise work with fixed
shapes.  The sparse tracker (flow/sparse.py) keeps exact per-point OpenCV
semantics for the pipeline and as the accuracy oracle; this module is the
throughput path (BASELINE.json north-star: dense pyramidal LK at 1080p).

Window-coherent dense formulation
---------------------------------
Naive dense LK warps the next image by the per-pixel flow field and
box-filters the residuals.  That decouples the window equations (each pixel's
residual is evaluated at its *own* flow, not the window center's), and on
aliased texture it converges to self-consistent noise (measured: median EPE
2.6 px where OpenCV per-point gets 0.014).  We instead expand the per-point
residual to first order in the within-window flow variation:

    J(q + v_p) ~= J(q + v_q) + grad_J(q + v_q) . (v_p - v_q)

and substitute the *template* gradient for the warped gradient (the
inverse-compositional trick — the same substitution OpenCV's per-point solver
makes).  The correction matrix box[gI gI^T] is then exactly the precomputed
structure tensor A, so the right-hand side needs only two box sums:

    b(p) = box[ gI * (D - gI.v) ](p) + A(p) . v(p)

with D = J(q+v_q) - I(q), gI = Scharr(prev).  Each solve is exact to first
order, so a few outer warp+solve rounds per level replace OpenCV's 10
resampling iterations; the per-level schedule (DenseLKConfig.iter_schedule,
default (1,1,1,6)) spends rounds at the top level where the search happens.

Implementation
--------------
Plain jax.numpy/lax, compiled by XLA: per outer round one bounded warp of
the next frame (ops.warp), two box sums and one 2x2 solve, fixed shapes and
per-pixel masked convergence.  The warp displacement is clamped to
DenseLKConfig.level_disp per level, which bounds the trackable motion.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from lk_tpu.config import DenseLKConfig, LKConfig
from lk_tpu.ops.blur import pyr_down
from lk_tpu.ops.boxfilter import box_sum
from lk_tpu.ops.gradients import scharr_derivatives
from lk_tpu.ops.resize import upsample2_linear
from lk_tpu.ops.warp import warp_by_flow

# OpenCV's fixed-point A-matrix is ours/1024 (see flow/sparse.py); its default
# minEigThreshold of 1e-4 maps to this on the normalized-gradient scale.
_MIN_EIG_SCALE = 1024.0



def _bounded_warp(img: jnp.ndarray, flow: jnp.ndarray, r: int) -> jnp.ndarray:
    """img(p + clamp(flow(p), -r, r)): the 4-tap bilinear gather warp,
    edge-clamped borders."""
    return warp_by_flow(img, jnp.clip(flow, -float(r), float(r)))


def _effective_cfg(
    cfg: LKConfig, dense_cfg: DenseLKConfig,
    hw: tuple[int, int] | None = None,
) -> LKConfig:
    """Apply DenseLKConfig.pyramid_levels to cfg.max_level (idempotent).

    The dense paths run their own pyramid depth (default 4 levels, see
    config.py) while the sparse tracker keeps the reference's maxLevel
    semantics.  Every function in this module that reads cfg.max_level
    routes through this, so direct calls into chain internals (bench.py)
    see the same depth as the public entry points.

    NOTE: an explicitly passed LKConfig.max_level is overridden whenever
    pyramid_levels != 0; depth sweeps must set
    DenseLKConfig(pyramid_levels=N) (or pyramid_levels=0 to honor
    max_level) — see config.py.

    hw (when known): clamp the depth so the TOP level stays at least the
    window size in both dims, matching cv2's buildOpticalFlowPyramid cap
    of maxLevel by winSize (reference LK_Final.py:81-86 passes 64-px ROIs
    through cv2, which caps internally); a 9x8 top level under a 15x15
    window is all border."""
    lv = dense_cfg.pyramid_levels
    if lv and lv - 1 != cfg.max_level:
        cfg = dataclasses.replace(cfg, max_level=lv - 1)
    if hw is not None:
        h, w = hw
        win_w, win_h = cfg.win_size
        ml = cfg.max_level
        while ml > 0 and ((h >> ml) < win_h or (w >> ml) < win_w):
            ml -= 1
        if ml != cfg.max_level:
            cfg = dataclasses.replace(cfg, max_level=ml)
    return cfg


class DenseFlowResult(NamedTuple):
    flow: jnp.ndarray      # (H, W, 2) float32, (dx, dy)
    min_eig: jnp.ndarray   # (H, W) float32, per-pixel min eigenvalue / area
    valid: jnp.ndarray     # (H, W) bool — structure tensor was solvable


def dense_lk_level(
    prev: jnp.ndarray,
    next_: jnp.ndarray,
    flow_init: jnp.ndarray,
    cfg: LKConfig = LKConfig(),
    dense_cfg: DenseLKConfig = DenseLKConfig(),
    max_disp: int | None = None,
) -> DenseFlowResult:
    """One pyramid level of window-coherent dense LK refinement."""
    win = cfg.win_size
    win_w, win_h = win
    area = jnp.float32(win_w * win_h)
    prev = prev.astype(jnp.float32)
    next_ = next_.astype(jnp.float32)
    r_disp = dense_cfg.max_disp if max_disp is None else max_disp
    eps2 = jnp.float32(cfg.eps * cfg.eps)
    bound = jnp.float32(r_disp)

    ix, iy = scharr_derivatives(prev)
    sum_dtype = jnp.bfloat16 if dense_cfg.bf16_box_sums else jnp.float32
    a11 = box_sum(ix * ix, win, sum_dtype=sum_dtype)
    a12 = box_sum(ix * iy, win, sum_dtype=sum_dtype)
    a22 = box_sum(iy * iy, win, sum_dtype=sum_dtype)
    det = a11 * a22 - a12 * a12
    min_eig = (a22 + a11 - jnp.sqrt((a11 - a22) ** 2 + 4.0 * a12 * a12)) / (
        2.0 * area
    )
    valid = (min_eig >= cfg.min_eig_threshold * _MIN_EIG_SCALE) & (det > 1e-7)
    inv_det = jnp.where(valid, 1.0 / det, 0.0)

    def body(_, carry):
        flow, active = carry
        jw = _bounded_warp(next_, flow, r_disp)
        # Inverse-compositional form: the warped gradient in the coherence
        # correction is replaced by the *template* gradient gI (the same
        # substitution OpenCV's per-point solver makes) — then the correction
        # matrix box(gI gI^T) IS the precomputed structure tensor, leaving 2
        # box sums per iteration instead of 6 and no warped-gradient Scharr.
        # Measured: equal-or-better EPE than the warped-gradient form.
        r = jw - prev - (ix * flow[..., 0] + iy * flow[..., 1])
        b1 = (box_sum(ix * r, win, sum_dtype=sum_dtype)
              + a11 * flow[..., 0] + a12 * flow[..., 1])
        b2 = (box_sum(iy * r, win, sum_dtype=sum_dtype)
              + a12 * flow[..., 0] + a22 * flow[..., 1])
        du = (a12 * b2 - a22 * b1) * inv_det
        dv = (a12 * b1 - a11 * b2) * inv_det
        upd = active & valid
        flow = jnp.where(
            upd[..., None], flow + jnp.stack([du, dv], axis=-1), flow
        )
        flow = jnp.clip(flow, -bound, bound)
        active = active & (du * du + dv * dv > eps2)
        return flow, active

    # Derive from `valid` (not a fresh constant) so the carry stays
    # axis-varying under shard_map row sharding (parallel/spatial.py).
    active0 = valid | ~valid
    flow, _ = jax.lax.fori_loop(
        0,
        dense_cfg.outer_iters,
        body,
        (flow_init.astype(jnp.float32), active0),
    )
    return DenseFlowResult(flow=flow, min_eig=min_eig, valid=valid)


def dense_pyramidal_lk_batched(
    prev: jnp.ndarray,
    next_: jnp.ndarray,
    cfg: LKConfig = LKConfig(),
    dense_cfg: DenseLKConfig = DenseLKConfig(),
) -> jnp.ndarray:
    """Batched dense flow via row-folding: (B, H, W) pairs -> (B, H, W, 2).

    The batch is folded into the row axis with per-frame edge-replicated
    guard bands large enough that no level's stencil (warp displacement +
    window + gradient) crosses a frame seam, so every op stays 2-D and one
    program serves any batch size.

    Border semantics inside the guard are edge-replication (the same rule
    the warp uses); box sums near frame borders see replicated rows instead
    of zero-padding — a border-only deviation from the unbatched path.
    """
    b, h, w = prev.shape
    cfg = _effective_cfg(cfg, dense_cfg, (h, w))
    top = cfg.max_level
    win_h = cfg.win_size[1]
    need = max(
        (dense_cfg.level_disp(lv) + win_h // 2 + 4) << lv
        for lv in range(top + 1)
    )
    mult = 1 << top
    # Per-frame height must be divisible by 2**max_level so decimation keeps
    # frames aligned: pad h itself up to the multiple (an odd h can never be
    # fixed by growing an integer guard), then use a multiple-of-mult guard.
    h_pad = -(-h // mult) * mult
    g = -(-need // mult) * mult

    def fold(x):
        xp = jnp.pad(x, ((0, 0), (g, g + (h_pad - h)), (0, 0)), mode="edge")
        return xp.reshape(b * (h_pad + 2 * g), w)

    folded = dense_pyramidal_lk(fold(prev), fold(next_), cfg,
                                dense_cfg=dense_cfg)
    flow = folded.flow.reshape(b, h_pad + 2 * g, w, 2)
    return flow[:, g:g + h]


def _upsample_flow(flow: jnp.ndarray, dst_h: int, dst_w: int) -> jnp.ndarray:
    up = upsample2_linear(jnp.moveaxis(flow, -1, 0), dst_h, dst_w)
    return jnp.moveaxis(up, 0, -1) * 2.0


def build_frame_levels(
    frame: jnp.ndarray,
    cfg: LKConfig = LKConfig(),
    dense_cfg: DenseLKConfig = DenseLKConfig(),
) -> tuple:
    """Pyramid levels of ONE frame, level 0 first (the video-mode scan
    carry; dense_pyramidal_lk builds both frames of a pair the same way)."""
    cfg = _effective_cfg(cfg, dense_cfg, frame.shape[-2:])
    levels = [frame.astype(jnp.float32)]
    for _ in range(cfg.max_level):
        levels.append(pyr_down(levels[-1], fast=dense_cfg.fast_pyramid))
    return tuple(levels)


def dense_pyramidal_lk(
    prev: jnp.ndarray,
    next_: jnp.ndarray,
    cfg: LKConfig = LKConfig(),
    init_flow: Optional[jnp.ndarray] = None,
    dense_cfg: DenseLKConfig = DenseLKConfig(),
) -> DenseFlowResult:
    """Coarse-to-fine dense LK over cfg.max_level+1 pyramid levels.

    prev/next: (H, W) float32 grayscale in 0..255.  Returns level-0 flow.
    """
    return dense_flow_from_levels(
        build_frame_levels(prev, cfg, dense_cfg),
        build_frame_levels(next_, cfg, dense_cfg),
        cfg, dense_cfg, init_flow=init_flow,
    )


def dense_pyramidal_lk_video(
    frames: jnp.ndarray,
    cfg: LKConfig = LKConfig(),
    dense_cfg: DenseLKConfig = DenseLKConfig(),
) -> DenseFlowResult:
    """Dense pyramidal LK over a video: (T, H, W) -> flows (T-1, H, W, 2).

    The production streaming form: a ``lax.scan`` carries each frame's
    pyramid to the next step, so every frame is decimated ONCE — the
    per-pair API rebuilds both pyramids per call, recomputing each
    interior frame's pyramid twice.  With the opt-in ``video_warm_start``
    the scan additionally carries the converged TOP-level flow as the next
    step's top-level seed and runs ``warm_top_iters`` there instead of the
    cold schedule's top count (OpenCV's OPTFLOW_USE_INITIAL_FLOW prior);
    the first pair runs the full cold schedule.  Without warm start (the
    default), per-pair numerics are preserved exactly (zero flow init per
    pair; only the redundant pyramid recomputation is gone).
    """
    assert frames.ndim == 3, frames.shape
    levels0 = build_frame_levels(frames[0], cfg, dense_cfg)

    if not dense_cfg.video_warm_start or frames.shape[0] <= 2:
        def step(carry, frame):
            nxt = build_frame_levels(frame, cfg, dense_cfg)
            return nxt, dense_flow_from_levels(carry, nxt, cfg, dense_cfg)

        _, out = jax.lax.scan(step, levels0, frames[1:].astype(jnp.float32))
        return out

    top = len(levels0) - 1
    warm_sched = tuple(dense_cfg.level_iters(lv) for lv in range(top)) + (
        dense_cfg.warm_top_iters,)
    warm_cfg = dataclasses.replace(dense_cfg, iter_schedule=warm_sched)

    # first pair: cold full schedule, seeding the warm chain
    levels1 = build_frame_levels(frames[1], cfg, dense_cfg)
    res0, top0 = dense_flow_from_levels(
        levels0, levels1, cfg, dense_cfg, return_top_flow=True)

    def step(carry, frame):
        levels, seed = carry
        nxt = build_frame_levels(frame, cfg, warm_cfg)
        res, topf = dense_flow_from_levels(
            levels, nxt, cfg, warm_cfg, init_flow=seed, return_top_flow=True)
        return (nxt, topf), res

    _, out = jax.lax.scan(
        step, (levels1, top0), frames[2:].astype(jnp.float32))
    return jax.tree_util.tree_map(
        lambda a, b: jnp.concatenate([a[None], b], axis=0), res0, out)


def dense_pyramidal_lk_multistream(
    frames: jnp.ndarray,
    cfg: LKConfig = LKConfig(),
    dense_cfg: DenseLKConfig = DenseLKConfig(),
) -> DenseFlowResult:
    """Dense video flow over N independent streams: (N, T, H, W) ->
    flows (N, T-1, H, W, 2).

    A ``lax.map`` of the video chain: the per-stream program compiles ONCE
    and every stream's carry (frame pyramid, warm-start seed) stays
    resident in device memory for the whole run.  Streams are fully
    independent.  For multi-device stream parallelism shard the N axis
    over a mesh axis (__graft_entry__.dryrun_multichip's dense stream-DP
    leg; chip_smoke.py --four-cards).
    """
    assert frames.ndim == 4, frames.shape
    return jax.lax.map(
        lambda fr: dense_pyramidal_lk_video(fr, cfg, dense_cfg), frames)


def dense_flow_from_levels(
    prev_levels,
    next_levels,
    cfg: LKConfig,
    dense_cfg: DenseLKConfig,
    init_flow: Optional[jnp.ndarray] = None,
    return_top_flow: bool = False,
) -> DenseFlowResult:
    """Coarse-to-fine refinement over prebuilt pyramid levels.

    prev_levels/next_levels: per-level (h, w) frames, level 0 first (as
    built by build_frame_levels).  init_flow seeds the TOP level (the
    video warm start); return_top_flow additionally returns the converged
    top-level flow as (h_top, w_top, 2) for the next step's seed.
    """
    cfg = _effective_cfg(cfg, dense_cfg, prev_levels[0].shape[-2:])
    top = cfg.max_level
    assert len(prev_levels) == len(next_levels) == top + 1, (
        len(prev_levels), top)
    h_top, w_top = prev_levels[top].shape[-2:]
    if init_flow is None:
        # derive from the level data (not a fresh constant) so the seed
        # stays axis-varying under shard_map stream sharding (cf. active0)
        flow = jnp.broadcast_to(
            (prev_levels[top] * 0.0)[..., None], (h_top, w_top, 2))
    else:
        flow = init_flow.astype(jnp.float32)

    result = None
    top_flow = None
    for level in range(top, -1, -1):
        if level != top:
            h, w = prev_levels[level].shape[-2:]
            flow = _upsample_flow(flow, h, w)
        result = dense_lk_level(
            prev_levels[level], next_levels[level], flow, cfg,
            dataclasses.replace(dense_cfg,
                                outer_iters=dense_cfg.level_iters(level)),
            max_disp=dense_cfg.level_disp(level),
        )
        flow = result.flow
        if level == top:
            top_flow = flow
    if return_top_flow:
        return result, top_flow
    return result
