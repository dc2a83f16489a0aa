"""Pipeline state pytree — the reference's loop locals made explicit.

The reference keeps its state in Python locals mutated per frame
(``p0s``, ``avg_len``, ``vp``, ``recent_cps``, ``tp_ult`` —
reference LK_Final.py:494-505); here it is one NamedTuple threaded through
``lax.scan``, so the whole video loop is a single compiled program and a
batch of streams is just a leading axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from lk_tpu.config import PipelineConfig
from lk_tpu.geometry.vanishing import VPState, init_vp_state


class PipelineState(NamedTuple):
    prev_gray: jnp.ndarray   # (H, W) f32 — processed previous frame
    pts: jnp.ndarray         # (G, S, 2) f32 tracking-point slots
    valid: jnp.ndarray       # (G, S) bool
    avg_len: jnp.ndarray     # (G,) f32 EMA average flow length
    vp: VPState
    tp_ult: jnp.ndarray      # () i32 frames since last replenish


class FrameOutputs(NamedTuple):
    """Per-frame outputs (fixed shapes, masked) — everything the host sinks
    (CSV rows, overlays, stats) need."""
    update_rows: jnp.ndarray   # (P, 2) VP after each in-frame update
    update_mask: jnp.ndarray   # (P,)
    show_row: jnp.ndarray      # (2,)
    show_mask: jnp.ndarray     # ()
    vp_hidden: jnp.ndarray     # ()
    cp_xy: jnp.ndarray         # (P, 2) accepted cross points
    cp_mask: jnp.ndarray       # (P,)
    line_start: jnp.ndarray    # (L, 2) accepted flow lines (draw_mask)
    line_stop: jnp.ndarray     # (L, 2)
    line_mask: jnp.ndarray     # (L,)
    pts: jnp.ndarray           # (G, S, 2) tracked points (circles overlay)
    pts_valid: jnp.ndarray     # (G, S)
    live_count: jnp.ndarray    # () i32
    vp_xy: jnp.ndarray         # (2,) current VP (post-frame)
    vp_init: jnp.ndarray       # () bool
    motion_labels: jnp.ndarray # (L,) i32 per-line motion class (geometry.classify)
    motion_fracs: jnp.ndarray  # (4,) static/away/toward/lateral fractions


class CompactChunkOutputs(NamedTuple):
    """Chunk-level FrameOutputs with the pair-capacity rows compacted.

    The per-frame transport reserves P = C(tp_num, 2) = 190 slots for VP
    update rows and accepted cross points while real frames emit ~14 on
    average on synthetic road scenes, so the padding dominates the
    device-to-host readback bytes.  The chunk runner sorts the masked rows of
    all T frames to the front ON DEVICE (order-stable; lax.sort with the
    coordinates as payload — no gathers) and transports only the first
    ``cap`` plus exact per-frame counts, so the host reconstructs the
    identical row stream; an overflowing chunk (total rows > cap) is
    detected from the counts and raised loudly (PipelineConfig.out_cap
    sizes the budget).
    """
    upd_rows: jnp.ndarray    # (K, 2) f32 — masked update rows, chunk-compacted
    upd_counts: jnp.ndarray  # (T,) i32 — rows per frame (exact, pre-cap)
    cp_rows: jnp.ndarray     # (K, 2) f32 — masked accepted CPs, chunk-compacted
    cp_counts: jnp.ndarray   # (T,) i32
    rest: FrameOutputs       # update_rows/update_mask/cp_xy/cp_mask dropped
                             # (zero-size placeholders keep the type stable)


def slots_per_group(cfg: PipelineConfig) -> int:
    return cfg.tp_num // cfg.num_groups


def init_pipeline_state(
    first_gray: jnp.ndarray, cfg: PipelineConfig
) -> PipelineState:
    """Zeroed state around the first processed frame; call the step's
    ``replenish`` once (or rely on the first forced replenish) to seed points.
    """
    g = cfg.num_groups
    s = slots_per_group(cfg)
    return PipelineState(
        prev_gray=first_gray.astype(jnp.float32),
        pts=jnp.zeros((g, s, 2), jnp.float32),
        valid=jnp.zeros((g, s), jnp.bool_),
        avg_len=jnp.full((g,), cfg.min_fl_len, jnp.float32),
        vp=init_vp_state(cfg),
        tp_ult=jnp.int32(0),
    )
