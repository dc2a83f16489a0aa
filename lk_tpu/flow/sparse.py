"""Sparse pyramidal Lucas–Kanade point tracker.

The JAX replacement for ``cv.calcOpticalFlowPyrLK``
(reference LK_Final.py:531-532; parameters at LK_Final.py:94-96), rebuilt as a
fixed-shape batched tensor program: points live in capacity-N slot arrays with
a validity mask; each point's refinement is a per-slot ``while_loop`` with
masked (converged/lost) updates (under vmap it runs until every point in the
batch converges); the slot axis is ``vmap``-ed, so the whole tracker is one
fused XLA program with no data-dependent shapes.

Semantics reproduced from OpenCV's pyramidal LK (float path):

* pyramid: pyrDown 5-tap Gaussian, REFLECT_101, levels padded by the window
  radius so border windows read reflected pixels;
* spatial gradients: Scharr (smooth [3,10,3]/16, diff [-1,0,1]/2) of the
  *previous* image, window-sampled once per level with the same bilinear
  weights as the image window;
* per level: structure tensor G from the prev window; gate on
  min-eigenvalue/area < 1e-4 (OpenCV minEigThreshold, converted to our
  normalized-gradient scale) or near-singular det;
* iterate (<= max_iters): sample next window at the current guess, residual
  b = sum(diff * [Ix, Iy]), step = solve(G, -b); stop when |step|^2 <= eps^2;
  OpenCV's oscillation damping (half-step back when successive deltas cancel
  to < 0.01) included;
* status=0 when the window leaves the (padded) image at level 0, or the
  structure tensor is degenerate at level 0;
* err = mean |window diff| in intensity units at level 0 (OpenCV default).

Validated against cv2: mean EPE < 0.1 px on synthetic and natural-image
motion (tests/test_flow_sparse.py).
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp

from lk_tpu.config import LKConfig
from lk_tpu.ops.blur import pyr_down
from lk_tpu.ops.gradients import scharr_derivatives


def build_tracking_pyramid(
    img: jnp.ndarray, max_level: int, pad: int
) -> List[jnp.ndarray]:
    """Pyramid whose levels are REFLECT_101-padded by ``pad`` pixels.

    Mirrors cv.buildOpticalFlowPyramid's winSize border padding so windows of
    points near the border read reflected content instead of clamped pixels.
    """
    levels = [img.astype(jnp.float32)]
    for _ in range(max_level):
        levels.append(pyr_down(levels[-1]))
    return [jnp.pad(lv, pad, mode="reflect") for lv in levels]


def _sample_patch(img_padded, corner_y, corner_x, fy, fx, win_h, win_w):
    """(win_h, win_w) bilinear patch given integer corner + fractional offset."""
    raw = jax.lax.dynamic_slice(
        img_padded, (corner_y, corner_x), (win_h + 1, win_w + 1)
    )
    a = raw[:-1, :-1]
    b = raw[:-1, 1:]
    c = raw[1:, :-1]
    d = raw[1:, 1:]
    w00 = (1.0 - fx) * (1.0 - fy)
    w01 = fx * (1.0 - fy)
    w10 = (1.0 - fx) * fy
    w11 = fx * fy
    return a * w00 + b * w01 + c * w10 + d * w11


def _track_one_level(
    prev_pad, ix_pad, iy_pad, next_pad, prev_pt, next_pt, status, cfg: LKConfig,
    pad: int, level: int, is_level0: bool, dims=None, base_y=0,
):
    """One pyramid level of refinement for a single point. All scalars traced.

    ``dims``/``base_y`` support row-folded multi-frame arrays (see
    track_points_batched): dims is the per-frame (h, w) and base_y the row
    offset of this point's frame inside the folded array.
    """
    win_w, win_h = cfg.win_size
    half_x = (win_w - 1) * 0.5
    half_y = (win_h - 1) * 0.5
    if dims is None:
        h = prev_pad.shape[0] - 2 * pad
        w = prev_pad.shape[1] - 2 * pad
    else:
        h, w = dims
    fph = h + 2 * pad                    # this frame's padded height

    # --- prev window (fixed for the level) ---------------------------------
    px = prev_pt[0] - half_x
    py = prev_pt[1] - half_y
    ipx = jnp.floor(px)
    ipy = jnp.floor(py)
    fx = (px - ipx).astype(jnp.float32)
    fy = (py - ipy).astype(jnp.float32)
    # OpenCV 'inside' test: integer corner within [-win, size) of the image.
    prev_inside = (
        (ipx >= -win_w) & (ipx < w) & (ipy >= -win_h) & (ipy < h)
    )
    cx = jnp.clip(ipx.astype(jnp.int32) + pad, 0, prev_pad.shape[1] - win_w - 1)
    cy = jnp.clip(ipy.astype(jnp.int32) + pad, 0, fph - win_h - 1) + base_y

    p_win = _sample_patch(prev_pad, cy, cx, fy, fx, win_h, win_w)
    ix_win = _sample_patch(ix_pad, cy, cx, fy, fx, win_h, win_w)
    iy_win = _sample_patch(iy_pad, cy, cx, fy, fx, win_h, win_w)

    a11 = jnp.sum(ix_win * ix_win)
    a12 = jnp.sum(ix_win * iy_win)
    a22 = jnp.sum(iy_win * iy_win)
    det = a11 * a22 - a12 * a12
    min_eig = (a22 + a11 - jnp.sqrt((a11 - a22) ** 2 + 4.0 * a12 * a12)) / (
        2.0 * win_w * win_h
    )
    # OpenCV's fixed-point derivs are 32x our normalized float derivs with an
    # extra FLT_SCALE=2^-20, so its A-matrix is ours/1024: its 1e-4 threshold
    # corresponds to min_eig/1024 on our scale.
    good_g = (min_eig >= cfg.min_eig_threshold * 1024.0) & (det > 1e-7)
    inv_det = jnp.where(det > 1e-7, 1.0 / det, 0.0)

    status = jnp.where(is_level0, status & prev_inside & good_g, status)
    do_refine = prev_inside & good_g

    # --- iterative refinement ---------------------------------------------
    # while_loop instead of a fixed fori: under vmap the loop runs only
    # until every point in the batch converges (typically 2-4 of the 10
    # allowed iterations) — same results as the masked fixed-trip version
    # in fewer trips.
    eps2 = jnp.float32(cfg.eps * cfg.eps)

    def cond(carry):
        _, _, active, _, j = carry
        return active & (j < cfg.max_iters)

    def body(carry):
        nxt, prev_delta, active, inside_ok, j = carry
        qx = nxt[0] - half_x
        qy = nxt[1] - half_y
        iqx = jnp.floor(qx)
        iqy = jnp.floor(qy)
        gx = (qx - iqx).astype(jnp.float32)
        gy = (qy - iqy).astype(jnp.float32)
        next_inside = (iqx >= -win_w) & (iqx < w) & (iqy >= -win_h) & (iqy < h)
        dx_c = jnp.clip(iqx.astype(jnp.int32) + pad, 0, next_pad.shape[1] - win_w - 1)
        dy_c = jnp.clip(iqy.astype(jnp.int32) + pad, 0, fph - win_h - 1) + base_y
        j_win = _sample_patch(next_pad, dy_c, dx_c, gy, gx, win_h, win_w)
        diff = j_win - p_win
        b1 = jnp.sum(diff * ix_win)
        b2 = jnp.sum(diff * iy_win)
        delta = jnp.stack(
            [(a12 * b2 - a22 * b1) * inv_det, (a12 * b1 - a11 * b2) * inv_det]
        )
        step_ok = active & next_inside
        new_nxt = jnp.where(step_ok, nxt + delta, nxt)
        converged = jnp.sum(delta * delta) <= eps2
        # OpenCV oscillation damping: successive deltas cancel -> back off half.
        osc = (
            (j > 0)
            & (jnp.abs(delta[0] + prev_delta[0]) < 0.01)
            & (jnp.abs(delta[1] + prev_delta[1]) < 0.01)
        )
        new_nxt = jnp.where(step_ok & osc, new_nxt - delta * 0.5, new_nxt)
        still_active = active & next_inside & ~converged & ~osc
        inside_ok = jnp.where(active, next_inside, inside_ok)
        return new_nxt, delta, still_active, inside_ok, j + 1

    init = (
        next_pt,
        jnp.zeros(2, jnp.float32),
        do_refine,
        jnp.array(True),
        jnp.int32(0),
    )
    next_pt, _, _, next_inside_final, _ = jax.lax.while_loop(
        cond, body, init
    )
    status = jnp.where(
        is_level0, status & (next_inside_final | ~do_refine), status
    )
    return next_pt, status, (p_win, a11, a12, a22)


def _track_one(pyr_data, pt, valid, cfg: LKConfig, pad: int,
               dims_per_level=None, frame_idx=None):
    """Track a single point through all pyramid levels.

    With dims_per_level/frame_idx set, the pyramid arrays are row-folded
    stacks of frames (track_points_batched) and the point belongs to frame
    ``frame_idx``.
    """
    win_w, win_h = cfg.win_size
    max_level = cfg.max_level
    status = valid
    next_pt = pt / jnp.float32(2 ** max_level)
    err = jnp.float32(0)
    for level in range(max_level, -1, -1):
        prev_pad, ix_pad, iy_pad, next_pad = pyr_data[level]
        if dims_per_level is None:
            dims = None
            base_y = 0
            fph = next_pad.shape[0]
        else:
            dims = dims_per_level[level]
            fph = dims[0] + 2 * pad
            # +2/+1: the per-frame guard rows added by fold()
            base_y = frame_idx * (fph + 2) + 1
        prev_pt = pt / jnp.float32(2 ** level)
        if level != max_level:
            next_pt = next_pt * 2.0
        next_pt, status, aux = _track_one_level(
            prev_pad, ix_pad, iy_pad, next_pad, prev_pt, next_pt, status, cfg,
            pad, level, is_level0=(level == 0), dims=dims, base_y=base_y,
        )
        if level == 0:
            # err: mean abs window diff at the final position (OpenCV default).
            p_win = aux[0]
            qx = next_pt[0] - (win_w - 1) * 0.5
            qy = next_pt[1] - (win_h - 1) * 0.5
            iqx = jnp.floor(qx)
            iqy = jnp.floor(qy)
            gx = (qx - iqx).astype(jnp.float32)
            gy = (qy - iqy).astype(jnp.float32)
            dx_c = jnp.clip(
                iqx.astype(jnp.int32) + pad, 0, next_pad.shape[1] - win_w - 1
            )
            dy_c = jnp.clip(
                iqy.astype(jnp.int32) + pad, 0, fph - win_h - 1
            ) + base_y
            j_win = _sample_patch(next_pad, dy_c, dx_c, gy, gx, win_h, win_w)
            err = jnp.mean(jnp.abs(j_win - p_win))
    return next_pt, status, err


def track_points(
    prev_img: jnp.ndarray,
    next_img: jnp.ndarray,
    pts: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: LKConfig = LKConfig(),
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Track ``pts`` (N, 2) float (x, y) from prev_img to next_img.

    Returns (new_pts (N,2) f32, status (N,) bool, err (N,) f32).  ``valid``
    masks inactive slots (their outputs are passthrough with status False).
    Equivalent of cv.calcOpticalFlowPyrLK (reference LK_Final.py:531-532).
    """
    win_w, win_h = cfg.win_size
    pad = max(win_w, win_h) + 2
    prev_levels = build_tracking_pyramid(prev_img, cfg.max_level, pad)
    next_levels = build_tracking_pyramid(next_img, cfg.max_level, pad)
    pyr_data = []
    for lv in range(cfg.max_level + 1):
        ix, iy = scharr_derivatives(prev_levels[lv])
        pyr_data.append((prev_levels[lv], ix, iy, next_levels[lv]))

    fn = jax.vmap(lambda p, v: _track_one(pyr_data, p, v, cfg, pad))
    new_pts, status, err = fn(pts.astype(jnp.float32), valid)
    new_pts = jnp.where(valid[:, None], new_pts, pts)
    return new_pts, status & valid, err


# superwindow geometry for the batched tracker: each point's refinement at a
# level samples inside ONE fetched region of `next` instead of slicing a
# window per iteration.  Rows/cols bound how far the iterate may wander from
# its per-level initial estimate before sampling clamps (OpenCV wanders
# < 2 px after pyramid initialization on real motion).
_SW_ROWS = 32
_SW_COLS = 48


# Extra level rows kept on each side of a tracker row band beyond the
# caller's full-res band: covers the window fetch extent (~24 rows), the
# superwindow fetch (~40) and mild coarse-to-fine estimate wander.  Points
# whose fetches would leave the banded crop sample CLAMPED content — the
# same deviation class as the superwindow clamp envelope; unreachable for
# in-band points under tracked-motion flow (parity-tested).
_BAND_MARGIN = 64


def _level_row_bands(h0: int, cfg: LKConfig, row_band):
    """Per-level (r0, r1) crops of a full-res tracker row band (or None)."""
    if row_band is None:
        return [None] * (cfg.max_level + 1)
    r0, r1 = row_band
    bands, h = [], h0
    for lv in range(cfg.max_level + 1):
        rr0 = max(0, (r0 >> lv) - _BAND_MARGIN)
        rr1 = min(h, -(-r1 // (1 << lv)) + _BAND_MARGIN)
        bands.append(None if (rr0 == 0 and rr1 >= h) else (rr0, rr1))
        h = -(-h // 2)
    return bands


def fold_tracking_levels(imgs: jnp.ndarray, cfg: LKConfig = LKConfig(),
                         row_band=None):
    """Pyramid + fold prep of a (B, H, W) frame batch for the batched
    tracker: per level, the B frames are reflect-padded (window pad + one
    guard row per frame seam) and folded along rows into one tall 2-D
    array.  Exposed so a video pipeline can CARRY the prepped form across
    steps — each frame batch is decimated and folded once, not twice (as
    next, then again as prev on the following frame).

    row_band: optional (r0, r1) full-res row interval where the caller's
    valid points live (e.g. the VP pipeline's ROI bounding box).  Each
    level keeps only that band (+ _BAND_MARGIN level rows per side), so
    the fold, Scharr and window passes touch ~15% of a dashcam frame.  The
    pyramid is decimated BEFORE cropping, so level content equals the uncropped
    build everywhere; the tracker must be given the same row_band."""
    b = imgs.shape[0]
    pad = max(cfg.win_size) + 2
    levels = [imgs.astype(jnp.float32)]
    for _ in range(cfg.max_level):
        levels.append(pyr_down(levels[-1], fast=cfg.fast_pyramid))
    bands = _level_row_bands(imgs.shape[1], cfg, row_band)

    def fold(x3, band):
        # one extra guard row above/below each frame: the 3x3 Scharr on the
        # folded image corrupts exactly one row at each frame seam, and the
        # guard keeps that row outside every window's reachable range
        if band is not None and band[0] >= pad + 1 \
                and band[1] + pad + 1 <= x3.shape[1]:
            # interior band: take the row pad from the TRUE frame (one
            # contiguous slice) instead of reflecting at the crop edge —
            # cheaper, and more faithful where it is reachable at all
            x3 = x3[:, band[0] - pad - 1:band[1] + pad + 1]
            xp = jnp.pad(x3, ((0, 0), (0, 0), (pad, pad)), mode="reflect")
        else:
            if band is not None:
                x3 = x3[:, band[0]:band[1]]
            xp = jnp.pad(x3, ((0, 0), (pad + 1, pad + 1), (pad, pad)),
                         mode="reflect")
        return xp.reshape(b * xp.shape[1], xp.shape[2])

    return tuple(fold(lv, bd) for lv, bd in zip(levels, bands))


def track_points_batched(
    prev_imgs: jnp.ndarray,
    next_imgs: jnp.ndarray,
    pts: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: LKConfig = LKConfig(),
    row_band=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Track (B, N, 2) points across B same-size frame pairs in one call.

    ``jax.vmap(track_points)`` over streams issues ~13 per-point window
    reads per level and iteration; this path restructures the memory
    access:

    * each pyramid level's B frames FOLD along rows into one tall 2-D
      image (per-frame reflect pads + 1 guard row, so windows and the 3x3
      Scharr never cross a frame seam);
    * per point per level, exactly TWO dynamic_slice reads: the
      (3, win+1, win+1) prev/ix/iy window at its fixed corner, and a
      (32, 48) superwindow of `next` around the level's initial estimate;
    * every refinement iteration samples bilinearly INSIDE the prefetched
      superwindow via weighted shift-selects (pure elementwise ops), not
      memory fetches.

    Deviation envelope: an iterate wandering > ~16 rows / ~24 cols from its
    per-level init samples a clamped window (the single-point oracle path
    resamples the true image); unreachable in the tracked-motion regime
    (parity-tested against track_points).
    """
    prev_folded = fold_tracking_levels(prev_imgs, cfg, row_band=row_band)
    p1, st, err, _ = track_points_batched_prepped(
        prev_folded, next_imgs, pts, valid, cfg, row_band=row_band)
    return p1, st, err


def track_points_batched_prepped(
    prev_folded,
    next_imgs: jnp.ndarray,
    pts: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: LKConfig = LKConfig(),
    row_band=None,
):
    """track_points_batched with the PREV frames' prep carried in: takes
    ``fold_tracking_levels`` output for the prev batch, folds only the next
    batch, and additionally returns next's folded levels so a video loop
    can pass them as the following step's ``prev_folded``.

    row_band: the SAME (r0, r1) full-res interval prev_folded was built
    with (see fold_tracking_levels) — valid points must lie inside it;
    results for points outside sample clamped band content (the serving
    pipeline's points always lie in the ROI band, and invalid slots are
    masked by the caller)."""
    b, h0, w0 = next_imgs.shape
    n = pts.shape[1]
    nn = b * n
    win_w, win_h = cfg.win_size
    pad = max(win_w, win_h) + 2
    eps2 = jnp.float32(cfg.eps * cfg.eps)
    half_x = (win_w - 1) * 0.5
    half_y = (win_h - 1) * 0.5
    bands = _level_row_bands(h0, cfg, row_band)
    h_levels, _h = [], h0
    for _ in range(cfg.max_level + 1):
        h_levels.append(_h)
        _h = -(-_h // 2)

    next_folded = fold_tracking_levels(next_imgs, cfg, row_band=row_band)
    assert len(prev_folded) == cfg.max_level + 1
    assert prev_folded[0].shape == next_folded[0].shape, (
        prev_folded[0].shape, next_folded[0].shape)

    frame_idx = jnp.repeat(jnp.arange(b, dtype=jnp.int32), n)
    flat_pts = pts.reshape(nn, 2).astype(jnp.float32)
    flat_valid = valid.reshape(nn)

    status = flat_valid
    next_pt = flat_pts / jnp.float32(2 ** cfg.max_level)
    err = jnp.zeros((nn,), jnp.float32)

    for level in range(cfg.max_level, -1, -1):
        prev_f = prev_folded[level]
        next_f = next_folded[level]
        # Scharr on the folded-and-padded image, like the single-image
        # path computes it on the padded level (reflect-pad of the
        # derivative would flip the sign in the pad region).
        ix_f, iy_f = scharr_derivatives(prev_f)
        stack3 = jnp.stack([prev_f, ix_f, iy_f])

        # per-frame level dims from the folded geometry (see fold above):
        # rows = b * (h + 2*(pad+1)), cols = w + 2*pad.  With a row band,
        # the folded rows cover only the band crop: memory row coords are
        # band-relative (r0 subtracted), while inside/status tests use the
        # TRUE level height.
        h = prev_f.shape[0] // b - 2 * (pad + 1)
        w = prev_f.shape[1] - 2 * pad
        band = bands[level]
        r0 = 0 if band is None else band[0]
        h_true = h_levels[level]
        assert h == (h_true if band is None else band[1] - band[0]), (
            "prev_folded was built with a different row_band", level, h)
        fph = h + 2 * pad
        fpw = w + 2 * pad
        base_y = frame_idx * (fph + 2) + 1
        sw_h = min(_SW_ROWS, fph)
        sw_w = min(_SW_COLS, fpw)

        prev_pt = flat_pts / jnp.float32(2 ** level)
        if level != cfg.max_level:
            next_pt = next_pt * 2.0

        # --- prev/ix/iy window: one (3, win+1, win+1) slice per point ------
        px = prev_pt[:, 0] - half_x
        py = prev_pt[:, 1] - half_y
        ipx = jnp.floor(px)
        ipy = jnp.floor(py)
        fx = (px - ipx).astype(jnp.float32)
        fy = (py - ipy).astype(jnp.float32)
        prev_inside = (
            (ipx >= -win_w) & (ipx < w) & (ipy >= -win_h) & (ipy < h_true)
        )
        cx = jnp.clip(ipx.astype(jnp.int32) + pad, 0, fpw - win_w - 1)
        cy = jnp.clip(ipy.astype(jnp.int32) - r0 + pad, 0, fph - win_h - 1
                      ) + base_y

        # superwindow corner: a pure function of the level's initial next_pt
        sy = jnp.clip(
            jnp.floor(next_pt[:, 1] - half_y).astype(jnp.int32) - r0 + pad
            - (sw_h - win_h - 1) // 2,
            0, fph - sw_h,
        )
        sx = jnp.clip(
            jnp.floor(next_pt[:, 0] - half_x).astype(jnp.int32) + pad
            - (sw_w - win_w - 1) // 2,
            0, fpw - sw_w,
        )

        raw = jax.vmap(
            lambda y, x: jax.lax.dynamic_slice(
                stack3, (0, y, x), (3, win_h + 1, win_w + 1)
            )
        )(cy, cx)
        sw = jax.vmap(
            lambda y, x: jax.lax.dynamic_slice(
                next_f, (y, x), (sw_h, sw_w)
            )
        )(sy + base_y, sx)
        w00 = ((1.0 - fx) * (1.0 - fy))[:, None, None]
        w01 = (fx * (1.0 - fy))[:, None, None]
        w10 = ((1.0 - fx) * fy)[:, None, None]
        w11 = (fx * fy)[:, None, None]

        def lerp4(r):
            return (r[:, :-1, :-1] * w00 + r[:, :-1, 1:] * w01
                    + r[:, 1:, :-1] * w10 + r[:, 1:, 1:] * w11)

        p_win = lerp4(raw[:, 0])
        ix_win = lerp4(raw[:, 1])
        iy_win = lerp4(raw[:, 2])

        a11 = jnp.sum(ix_win * ix_win, axis=(1, 2))
        a12 = jnp.sum(ix_win * iy_win, axis=(1, 2))
        a22 = jnp.sum(iy_win * iy_win, axis=(1, 2))
        det = a11 * a22 - a12 * a12
        min_eig = (
            a22 + a11 - jnp.sqrt((a11 - a22) ** 2 + 4.0 * a12 * a12)
        ) / (2.0 * win_w * win_h)
        good_g = (min_eig >= cfg.min_eig_threshold * 1024.0) & (det > 1e-7)
        inv_det = jnp.where(det > 1e-7, 1.0 / det, 0.0)
        if level == 0:
            status = status & prev_inside & good_g
        do_refine = prev_inside & good_g

        # --- next superwindow: sliced above alongside the prev windows -----
        max_dy = sw_h - win_h - 1
        max_dx = sw_w - win_w - 1

        def sample_next(q):
            """Bilinear (win_h, win_w) windows at q (N, 2) inside sw."""
            qx = q[:, 0] - half_x
            qy = q[:, 1] - half_y
            iqx = jnp.floor(qx)
            iqy = jnp.floor(qy)
            gx = (qx - iqx).astype(jnp.float32)
            gy = (qy - iqy).astype(jnp.float32)
            dyi = jnp.clip(iqy.astype(jnp.int32) - r0 + pad - sy, 0, max_dy)
            dxi = jnp.clip(iqx.astype(jnp.int32) + pad - sx, 0, max_dx)
            vert = jnp.zeros((nn, win_h, sw_w), jnp.float32)
            for d in range(max_dy + 2):
                m = ((dyi == d).astype(jnp.float32) * (1.0 - gy)
                     + (dyi == d - 1).astype(jnp.float32) * gy)
                vert = vert + m[:, None, None] * sw[:, d:d + win_h, :]
            out = jnp.zeros((nn, win_h, win_w), jnp.float32)
            for d in range(max_dx + 2):
                m = ((dxi == d).astype(jnp.float32) * (1.0 - gx)
                     + (dxi == d - 1).astype(jnp.float32) * gx)
                out = out + m[:, None, None] * vert[:, :, d:d + win_w]
            return out

        def inside_next(q):
            iqx = jnp.floor(q[:, 0] - half_x)
            iqy = jnp.floor(q[:, 1] - half_y)
            return ((iqx >= -win_w) & (iqx < w)
                    & (iqy >= -win_h) & (iqy < h_true))

        def cond(carry):
            _, _, active, _, j = carry
            return jnp.any(active) & (j < cfg.max_iters)

        def body(carry):
            nxt, prev_delta, active, inside_ok, j = carry
            j_win = sample_next(nxt)
            nx_inside = inside_next(nxt)
            diff = j_win - p_win
            b1 = jnp.sum(diff * ix_win, axis=(1, 2))
            b2 = jnp.sum(diff * iy_win, axis=(1, 2))
            delta = jnp.stack(
                [(a12 * b2 - a22 * b1) * inv_det,
                 (a12 * b1 - a11 * b2) * inv_det], axis=-1)
            step_ok = active & nx_inside
            new_nxt = jnp.where(step_ok[:, None], nxt + delta, nxt)
            converged = jnp.sum(delta * delta, axis=-1) <= eps2
            osc = (
                (j > 0)
                & (jnp.abs(delta[:, 0] + prev_delta[:, 0]) < 0.01)
                & (jnp.abs(delta[:, 1] + prev_delta[:, 1]) < 0.01)
            )
            new_nxt = jnp.where(
                (step_ok & osc)[:, None], new_nxt - delta * 0.5, new_nxt)
            still = active & nx_inside & ~converged & ~osc
            inside_ok = jnp.where(active, nx_inside, inside_ok)
            return new_nxt, delta, still, inside_ok, j + 1

        init = (
            next_pt,
            jnp.zeros((nn, 2), jnp.float32),
            do_refine,
            jnp.ones((nn,), bool),
            jnp.int32(0),
        )
        next_pt, _, _, nx_inside_final, _ = jax.lax.while_loop(
            cond, body, init)
        if level == 0:
            status = status & (nx_inside_final | ~do_refine)
            j_win = sample_next(next_pt)
            err = jnp.mean(jnp.abs(j_win - p_win), axis=(1, 2))

    new_pts = jnp.where(flat_valid[:, None], next_pt, flat_pts)
    return (
        new_pts.reshape(b, n, 2),
        (status & flat_valid).reshape(b, n),
        err.reshape(b, n),
        next_folded,
    )
