"""The per-frame step function: L1 preprocess through L5 VP update.

Composes the layers exactly in the reference's order (reference
LK_Final.py:508-705):

  track (flow.sparse) -> ROI containment gate (checkInside) -> flow-line
  stats + EMA filter (geometry.flowlines) -> cross-point/VP pair scan
  (geometry.vanishing) -> show/hide -> replenishment (features) -> counters.

Replenishment (LK_Final.py:684-703): triggered when live points fall under
tp_num*tp_update_rate or every tp_update_time frames; group j pools the
greedy corners of its sub-masks in order; policy "REP" replaces both groups
only when *both* found corners (LK_Final.py:697-699), "EXT" appends and keeps
the newest tp_num (LK3_classification.py:530-538).

checkInside (LK_Final.py:322-345): a point survives if its LK status is set
and the ROI mask at floor(y), floor(x) is nonzero.  The reference's bounds
test uses ``>`` (an equal coordinate would crash numpy indexing); we treat
out-of-range as outside — the only defined behavior.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from lk_tpu.config import PipelineConfig
from lk_tpu.features.shi_tomasi import (
    good_features_from_response,
    min_eig_response,
)
from lk_tpu.flow.sparse import track_points
from lk_tpu.geometry.flowlines import flow_line_filter, flow_line_stats
from lk_tpu.geometry.vanishing import process_frame_pairs, vp_show_step
from lk_tpu.ops.blur import gaussian_blur3
from lk_tpu.ops.color import bgr_to_gray
from lk_tpu.ops.resize import resize_area
from lk_tpu.ops.tone import contrast_brightness
from lk_tpu.pipeline.state import FrameOutputs, PipelineState, slots_per_group


def preprocess_frame(
    bgr: jnp.ndarray, cfg: PipelineConfig, out_h: int, out_w: int
) -> jnp.ndarray:
    """L0+L1: BGR -> gray -> aspect resize -> (optional tone) -> 3x3 blur.

    Reference order is resize-then-gray (LK_Final.py:517-518,400-421); both
    are linear so they commute in float — we convert first so the resize
    matmuls run on 1 channel instead of 3.
    """
    gray = bgr_to_gray(bgr.astype(jnp.float32))
    gray = resize_area(gray, out_h, out_w)
    if cfg.contrast_enhance:
        gray = contrast_brightness(gray)
    return gaussian_blur3(gray)


def check_inside(
    pts: jnp.ndarray, mask: jnp.ndarray, status: jnp.ndarray
) -> jnp.ndarray:
    """Reference checkInside (LK_Final.py:322-345) vectorized over slots."""
    h, w = mask.shape[-2:]
    x = jnp.floor(pts[..., 0]).astype(jnp.int32)
    y = jnp.floor(pts[..., 1]).astype(jnp.int32)
    in_bounds = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    xc = jnp.clip(x, 0, w - 1)
    yc = jnp.clip(y, 0, h - 1)
    inside = mask[yc, xc] > 0
    return status & in_bounds & inside


def compact_slots(pts: jnp.ndarray, valid: jnp.ndarray):
    """Stable-move valid entries to the slot prefix (order preserved)."""
    order = jnp.argsort(~valid, stable=True)
    return pts[order], valid[order]


def tracker_row_band(cfg: PipelineConfig, height: int, sub_masks):
    """Full-res (r0, r1) row interval every VALID tracking point lives in,
    or None when banding is off / the ROI is degenerate.

    Valid points sit inside the ROI sub-masks: detection only places
    corners there and check_inside culls escapees every frame (reference
    LK_Final.py:537-541), so the batched tracker may crop its pyramid
    levels to this band (flow.sparse.fold_tracking_levels row_band; the
    per-level fetch/wander margins live there).  The 16-row slack covers
    sub-pixel window centers straddling the mask edge."""
    if not cfg.track_row_band:
        return None
    import numpy as _np

    rows = _np.where((_np.asarray(sub_masks) > 0).any(0).any(1))[0]
    if rows.size == 0:
        return None
    return (max(int(rows.min()) - 16, 0),
            min(int(rows.max()) + 17, height))


def make_step(
    cfg: PipelineConfig,
    frame_size: Tuple[int, int],
    roi_mask: jnp.ndarray,
    sub_masks: jnp.ndarray,
):
    """Build the jittable per-frame step for a given geometry.

    frame_size: (W, H) of the processed frames.
    roi_mask: (H, W) full trapezoid; sub_masks: (4, H, W) quadrant masks.
    Returns step(state, gray_frame) -> (state, FrameOutputs).
    """
    width, height = frame_size
    g = cfg.num_groups
    s = slots_per_group(cfg)
    masks_per_group = sub_masks.shape[0] // g
    fcfg = cfg.features

    # Corners can only land inside the (static) ROI sub-masks, so both the
    # response map and the greedy argmax/suppression loops run on the ROI's
    # bounding box, not the full frame — the response needs a stencil halo,
    # and the crop aligns to (8, 128) so the slice is a plain tile copy.
    import numpy as _np

    _sub_np = _np.asarray(sub_masks) > 0
    _ys, _xs = _np.where(_sub_np.any(0))
    if _ys.size == 0:       # degenerate ROI: keep the full-frame behavior
        _ys = _np.array([0, height - 1])
        _xs = _np.array([0, width - 1])
    _halo = fcfg.block_size // 2 + 2
    _y0 = (max(int(_ys.min()) - _halo, 0) // 8) * 8
    _x0 = (max(int(_xs.min()) - _halo, 0) // 128) * 128
    _y1 = min(-(-(int(_ys.max()) + 1 + _halo) // 8) * 8, height)
    _x1 = min(-(-(int(_xs.max()) + 1 + _halo) // 128) * 128, width)
    _crop_off = jnp.asarray([_x0, _y0], jnp.float32)
    sub_masks_crop = sub_masks[:, _y0:_y1, _x0:_x1]

    def detect(gray: jnp.ndarray):
        """Per-group corner pools in sub-mask order (LK_Final.py:481-492)."""
        resp = min_eig_response(gray[_y0:_y1, _x0:_x1], fcfg.block_size)
        pts_groups = []
        valid_groups = []
        for gi in range(g):
            xs, vs = [], []
            for mi in range(masks_per_group):
                xy, val = good_features_from_response(
                    resp, sub_masks_crop[gi * masks_per_group + mi], fcfg
                )
                xs.append(xy + _crop_off)
                vs.append(val)
            pxy = jnp.concatenate(xs, axis=0)
            pval = jnp.concatenate(vs, axis=0)
            pxy, pval = compact_slots(pxy, pval)
            pts_groups.append(jnp.where(pval[:s, None], pxy[:s], 0.0))
            valid_groups.append(pval[:s])
        return jnp.stack(pts_groups), jnp.stack(valid_groups)

    def _pre(state: PipelineState, gray: jnp.ndarray, p1, st):
        """L2-L5 + replenish trigger: everything between tracking and the
        (conditional) re-detection."""
        flat_pts = state.pts.reshape(g * s, 2)

        # --- L2: ROI containment ------------------------------------------
        st = check_inside(p1, roi_mask, st)

        # --- L4: flow lines + EMA filter per group -------------------------
        new = p1.reshape(g, s, 2)
        surv = st.reshape(g, s)
        accepted_groups = []
        new_avg = []
        stats_all = flow_line_stats(flat_pts, p1)
        for gi in range(g):
            stats_g = jax.tree_util.tree_map(
                lambda a: a[gi * s:(gi + 1) * s], stats_all
            )
            acc, avg = flow_line_filter(
                stats_g, surv[gi], state.avg_len[gi],
                cfg.min_fl_len, cfg.fl_update_rate,
                update_before_test=cfg.avg_len_update_before_test,
            )
            accepted_groups.append(acc)
            new_avg.append(avg)
        accepted = jnp.concatenate(accepted_groups)
        avg_len = jnp.stack(new_avg)

        # --- L5: cross points + VP ----------------------------------------
        vp_state, geom = process_frame_pairs(
            state.vp, stats_all, accepted, cfg, (width, height)
        )
        vp_state, geom = vp_show_step(vp_state, geom, cfg)
        if cfg.reset_avg_len_on_hide:
            avg_len = jnp.where(
                geom.vp_hidden, jnp.full_like(avg_len, cfg.min_fl_len), avg_len
            )

        # --- survivors become next frame's points --------------------------
        pts_after = jnp.where(surv[..., None], new, 0.0)
        valid_after = surv
        live = jnp.sum(valid_after)

        # --- replenishment trigger ------------------------------------------
        # Detection runs on the *current* frame (processed_old_frame has
        # already been swapped at LK_Final.py:669 by the time :691 detects).
        trigger = (
            live < jnp.int32(cfg.tp_num * cfg.tp_update_rate)
        ) | (state.tp_ult == cfg.tp_update_time)
        return dict(
            trigger=trigger, live=live, surv=surv, new=new,
            pts_after=pts_after, valid_after=valid_after, avg_len=avg_len,
            vp_state=vp_state, geom=geom, stats_all=stats_all,
            accepted=accepted,
        )

    def _post(state: PipelineState, gray: jnp.ndarray, ctx,
              det_pts, det_valid):
        """Apply replenishment + assemble the new state and outputs."""
        trigger = ctx["trigger"]
        live = ctx["live"]
        surv = ctx["surv"]
        new = ctx["new"]
        pts_after = ctx["pts_after"]
        valid_after = ctx["valid_after"]
        avg_len = ctx["avg_len"]
        vp_state = ctx["vp_state"]
        geom = ctx["geom"]
        stats_all = ctx["stats_all"]
        accepted = ctx["accepted"]
        group_nonempty = jnp.any(det_valid, axis=1)
        if cfg.fl_upd_meth == "REP":
            do_rep = trigger & jnp.all(group_nonempty)
            pts_next = jnp.where(do_rep, det_pts, pts_after)
            valid_next = jnp.where(do_rep, det_valid, valid_after)
        elif cfg.fl_upd_meth == "EXT":
            # old survivors first, new appended, keep the newest s per group
            # (LK3_classification.py:530-538 keeps the *last* TP_NUM).
            cp_, cv_ = jax.vmap(compact_slots)(pts_after, valid_after)
            both_p = jnp.concatenate([cp_, det_pts], axis=1)
            both_v = jnp.concatenate([cv_, det_valid], axis=1)
            n_tot = jnp.sum(both_v, axis=1, keepdims=True)
            # keep the last s valid entries: rank valid entries by order,
            # drop the oldest beyond capacity.
            rank = jnp.cumsum(both_v, axis=1)  # 1-based rank among valid
            keep = both_v & (rank > jnp.maximum(n_tot - s, 0))
            ext_p, ext_v = jax.vmap(compact_slots)(
                jnp.where(keep[..., None], both_p, 0.0), keep
            )
            pts_next = jnp.where(trigger, ext_p[:, :s], pts_after)
            valid_next = jnp.where(trigger, ext_v[:, :s], valid_after)
        else:
            raise ValueError(cfg.fl_upd_meth)
        tp_ult = jnp.where(trigger, 0, state.tp_ult) + 1

        new_state = PipelineState(
            prev_gray=gray,
            pts=pts_next,
            valid=valid_next,
            avg_len=avg_len,
            vp=vp_state,
            tp_ult=tp_ult,
        )
        # motion classification relative to the current VP (per accepted line)
        from lk_tpu.geometry.classify import classify_flow_lines

        motion = classify_flow_lines(
            stats_all.start, stats_all.stop,
            accepted & vp_state.vp_init, vp_state.vp_xy,
        )
        outputs = FrameOutputs(
            update_rows=geom.update_rows,
            update_mask=geom.update_mask,
            show_row=geom.show_row,
            show_mask=geom.show_mask,
            vp_hidden=geom.vp_hidden,
            cp_xy=geom.cp_xy,
            cp_mask=geom.cp_mask,
            line_start=stats_all.start,
            line_stop=stats_all.stop,
            line_mask=accepted,
            pts=new,
            pts_valid=surv,
            live_count=live,
            vp_xy=vp_state.vp_xy,
            vp_init=vp_state.vp_init,
            motion_labels=motion.labels,
            motion_fracs=jnp.stack([
                motion.frac_static, motion.frac_away,
                motion.frac_toward, motion.frac_lateral,
            ]),
        )
        return new_state, outputs

    def step(state: PipelineState, gray: jnp.ndarray):
        gray = gray.astype(jnp.float32)
        # --- L3: track all slots in one call (shared pyramids) -------------
        flat_pts = state.pts.reshape(g * s, 2)
        flat_valid = state.valid.reshape(g * s)
        p1, st, _err = track_points(
            state.prev_gray, gray, flat_pts, flat_valid, cfg.lk
        )
        ctx = _pre(state, gray, p1, st)
        # lax.cond executes only the taken branch: detection (response map +
        # greedy selections) runs only on replenish frames.
        det_pts, det_valid = jax.lax.cond(
            ctx["trigger"],
            lambda gg: detect(gg),
            lambda gg: (
                jnp.zeros((g, s, 2), jnp.float32),
                jnp.zeros((g, s), jnp.bool_),
            ),
            gray,
        )
        return _post(state, gray, ctx, det_pts, det_valid)

    def step_batched(carry, grays: jnp.ndarray):
        """Step B streams at once; carry = (states, prev_folded).

        states' leaves have a leading B axis; prev_folded is the previous
        frame batch's tracker prep (flow.sparse.fold_tracking_levels) —
        carrying it means each frame batch is decimated/folded once, not
        twice (chunk runners seed it from states.prev_gray at chunk start).

        Two batching hazards drive this variant (vs jax.vmap(step)):
        tracking vmapped over streams turns window reads into many small
        gathers (flow.sparse.track_points_batched restructures them), and a
        vmapped lax.cond runs BOTH branches — so detection is gated on
        ``any(trigger)`` across streams (a scalar), keeping the per-stream
        semantics while still skipping the work on most frames.
        """
        from lk_tpu.flow.sparse import track_points_batched_prepped

        states, prev_folded = carry
        grays = grays.astype(jnp.float32)
        b = grays.shape[0]
        p1, st, _err, next_folded = track_points_batched_prepped(
            prev_folded, grays,
            states.pts.reshape(b, g * s, 2),
            states.valid.reshape(b, g * s), cfg.lk,
            row_band=tracker_row_band(cfg, height, sub_masks),
        )
        ctx = jax.vmap(_pre)(states, grays, p1, st)
        zeros = (
            jnp.zeros((b, g, s, 2), jnp.float32),
            jnp.zeros((b, g, s), jnp.bool_),
        )
        det_pts, det_valid = jax.lax.cond(
            jnp.any(ctx["trigger"]),
            lambda gg: jax.vmap(detect)(gg),
            lambda gg: zeros,
            grays,
        )
        states, outs = jax.vmap(_post)(states, grays, ctx, det_pts, det_valid)
        return (states, next_folded), outs

    return step, detect, step_batched
