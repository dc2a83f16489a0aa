"""Polygon -> mask rasterization (replaces ``cv.fillPoly`` for the ROI).

The reference builds one road-trapezoid mask plus four quadrant sub-masks from
integer-vertex convex quads (reference LK_Final.py:448-472).  Here a convex
polygon is the intersection of half-planes, so the mask is a product of edge
sign tests evaluated on a pixel-center grid — pure vector math, no scanline.

Boundary semantics: pixels exactly on an edge are included (matching
cv.fillPoly's inclusive boundary within ~1 px; the ROI gates only ever see
tracked points well inside, and our features/checkInside use these same masks,
so the pipeline is self-consistent).  Masks are static per run; prefer
building them once at trace time via ``masks_from_points``.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp
import numpy as np


def fill_convex_poly(h: int, w: int, pts) -> jnp.ndarray:
    """Rasterize a convex polygon given as (N, 2) integer (x, y) vertices.

    Returns a float32 (h, w) mask of 0/1.  Vertex order may be CW or CCW.
    """
    pts = jnp.asarray(pts, dtype=jnp.float32)
    n = pts.shape[0]
    ys = jnp.arange(h, dtype=jnp.float32)[:, None]
    xs = jnp.arange(w, dtype=jnp.float32)[None, :]
    # Signed area to get orientation: positive = CCW in image coords.
    x0, y0 = pts[:, 0], pts[:, 1]
    x1 = jnp.roll(x0, -1)
    y1 = jnp.roll(y0, -1)
    area2 = jnp.sum(x0 * y1 - x1 * y0)
    orient = jnp.where(area2 >= 0, 1.0, -1.0)
    inside = jnp.ones((h, w), dtype=jnp.bool_)
    for i in range(n):
        ex = x1[i] - x0[i]
        ey = y1[i] - y0[i]
        cross = ex * (ys - y0[i]) - ey * (xs - x0[i])
        inside = inside & (orient * cross >= 0)
    return inside.astype(jnp.float32)


def masks_from_points(h: int, w: int, quads: Sequence[np.ndarray]) -> jnp.ndarray:
    """Stack of convex-quad masks, shape (len(quads), h, w) float32 0/1."""
    return jnp.stack([fill_convex_poly(h, w, q) for q in quads])


def roi_mask_points(width: int, height: int, roi) -> np.ndarray:
    """The 9 labeled ROI construction points (reference LK_Final.py:448-456).

    Returns (9, 2) int array in the reference's ordering:
    0 center, 1 bottom-left, 2 bottom-mid, 3 bottom-right, 4 mid-right,
    5 top-right, 6 top-mid, 7 top-left, 8 mid-left.
    """
    b = dict(
        outerL=int(width * roi.outer_l),
        outerU=int(height * roi.outer_u),
        outerR=int(width * roi.outer_r),
        outerD=int(height * roi.outer_d),
        innerL=int(width * roi.inner_l),
        innerU=int(height * roi.inner_u),
        innerR=int(width * roi.inner_r),
    )
    return np.array(
        [
            [width // 2, (b["outerD"] + b["innerU"]) // 2],
            [b["outerL"], b["outerD"]],
            [width // 2, b["outerD"]],
            [b["outerR"], b["outerD"]],
            [(b["outerR"] + b["innerR"]) // 2, (b["outerD"] + b["innerU"]) // 2],
            [b["innerR"], b["innerU"]],
            [width // 2, b["innerU"]],
            [b["innerL"], b["innerU"]],
            [(b["outerL"] + b["innerL"]) // 2, (b["outerD"] + b["innerU"]) // 2],
        ],
        dtype=np.int32,
    )


def build_roi_masks(width: int, height: int, roi) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(full_mask (H,W), sub_masks (4,H,W)) for the VP pipelines.

    Reproduces the quad layouts at reference LK_Final.py:458-472: the full
    trapezoid uses points [1,3,5,7]; the four quadrant sub-masks split it
    around the center point [0].
    """
    p = roi_mask_points(width, height, roi)
    full = fill_convex_poly(height, width, p[[1, 3, 5, 7]])
    subs = masks_from_points(
        height,
        width,
        [p[[0, 8, 1, 2]], p[[0, 2, 3, 4]], p[[0, 4, 5, 6]], p[[0, 6, 7, 8]]],
    )
    return full, subs
