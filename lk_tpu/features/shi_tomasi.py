"""Shi–Tomasi corner selection — the JAX ``cv.goodFeaturesToTrack``.

Reference call sites: LK_Final.py:488,691 (maxCorners=TP_NUM/4=5 per ROI
sub-mask, qualityLevel=0.3, minDistance=7, blockSize=7).

Pipeline (mirrors OpenCV's):

1. dense min-eigenvalue response: Sobel-3 gradient products box-filtered over
   blockSize; min-eig of the 2x2 structure tensor.  qualityLevel thresholds
   *relative* to the max response, so absolute gradient scale cancels and we
   use normalized Sobel;
2. 3x3 max-pool non-maximum suppression + relative threshold + optional mask;
3. greedy min-distance selection realized as iterative argmax + disc
   suppression: take the strongest surviving peak, zero a minDistance disc
   around it, repeat maxCorners times.  This is *exactly* OpenCV's greedy
   rule (sort by response, accept unless within minDistance of an accepted
   point) — the sorted-accept order and max-then-suppress order pick the
   same set — with only maxCorners cheap reductions instead of a full-image
   sort (lax.top_k over all ~415k responses of an 860x483 frame).

Returns fixed-capacity slots + validity mask — the framework's universal
representation for "a variable number of points" (SURVEY.md §7 design stance).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from lk_tpu.config import FeatureConfig
from lk_tpu.ops.boxfilter import box_sum
from lk_tpu.ops.gradients import sobel_derivatives


def min_eig_response(img: jnp.ndarray, block_size: int = 7) -> jnp.ndarray:
    """Dense Shi–Tomasi response: min eigenvalue of the structure tensor.

    Relative magnitudes match cv.cornerMinEigenVal (absolute scale differs by
    a constant factor, which qualityLevel thresholding cancels).
    """
    ix, iy = sobel_derivatives(img)
    win = (block_size, block_size)
    # True min eigenvalue of [[A,B],[B,C]]: with a=A/2, c=C/2 the cross term
    # stays unhalved: lambda_min = (a+c) - sqrt((a-c)^2 + B^2).
    a = box_sum(ix * ix, win, border="reflect") * 0.5
    b = box_sum(ix * iy, win, border="reflect")
    c = box_sum(iy * iy, win, border="reflect") * 0.5
    return (a + c) - jnp.sqrt((a - c) * (a - c) + b * b)


def _max_pool3(x: jnp.ndarray) -> jnp.ndarray:
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max,
        window_dimensions=[1] * (x.ndim - 2) + [3, 3],
        window_strides=[1] * x.ndim,
        padding=[(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)],
    )


def good_features_to_track(
    img: jnp.ndarray,
    mask: Optional[jnp.ndarray],
    cfg: FeatureConfig = FeatureConfig(),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Select up to cfg.max_corners corners; returns ((max_corners, 2) xy, valid).

    ``mask``: optional (H, W) 0/1 float — corners only where mask > 0
    (the reference's ROI sub-masks, LK_Final.py:488).
    """
    resp = min_eig_response(img, cfg.block_size)
    return good_features_from_response(resp, mask, cfg)


def good_features_from_response(
    resp: jnp.ndarray,
    mask: Optional[jnp.ndarray],
    cfg: FeatureConfig = FeatureConfig(),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Greedy corner selection from a precomputed response map.

    Split out so the pipeline computes min_eig_response once per frame and
    selects under each of the 4 ROI sub-masks (reference LK_Final.py:485-492)
    without recomputing gradients.
    """
    h, w = resp.shape[-2:]
    if mask is not None:
        resp = jnp.where(mask > 0, resp, 0.0)
    max_resp = jnp.max(resp)
    thresh = max_resp * jnp.float32(cfg.quality_level)
    is_peak = (resp >= _max_pool3(resp)) & (resp > thresh) & (resp > 0)
    cand = jnp.where(is_peak, resp, 0.0)

    min_d2 = jnp.float32(cfg.min_distance * cfg.min_distance)
    n_out = cfg.max_corners
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)

    def body(i, state):
        cand, out_xy, out_valid = state
        # Two-stage argmax (rows then columns) instead of a flat argmax
        # over an (H*W,) reshape: two small reductions per pick.
        row_max = jnp.max(cand, axis=1)
        yi = jnp.argmax(row_max)
        row = jax.lax.dynamic_slice(cand, (yi, 0), (1, w))[0]
        xi = jnp.argmax(row)
        val = row_max[yi]
        x = xi.astype(jnp.float32)
        y = yi.astype(jnp.float32)
        take = val > 0
        out_xy = jnp.where(take, out_xy.at[i].set(jnp.stack([x, y])), out_xy)
        out_valid = jnp.where(take, out_valid.at[i].set(True), out_valid)
        # Suppress the minDistance disc (OpenCV greedy: accepted point blocks
        # all weaker candidates within minDistance, strict <).
        d2 = (xs - x) ** 2 + (ys - y) ** 2
        cand = jnp.where(take & (d2 < min_d2), 0.0, cand)
        return cand, out_xy, out_valid

    init = (
        cand,
        jnp.zeros((n_out, 2), jnp.float32),
        jnp.zeros((n_out,), jnp.bool_),
    )
    _, out_xy, out_valid = jax.lax.fori_loop(0, n_out, body, init)
    return out_xy, out_valid
