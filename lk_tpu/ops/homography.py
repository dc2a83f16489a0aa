"""Perspective transform ops (the reference's bird's-eye experiment,
LK3_classification.py:371-381 — commented out there, first-class here).

``get_perspective_transform`` solves the 8-DOF homography from 4 point
correspondences (cv.getPerspectiveTransform equivalent); ``warp_perspective``
resamples through it with bilinear gathers.  The warp is a setup-time /
analysis op (one gather per output pixel), not on the per-frame hot path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from lk_tpu.ops.warp import bilinear_sample


def get_perspective_transform(src: jnp.ndarray, dst: jnp.ndarray) -> jnp.ndarray:
    """3x3 homography H with dst ~ H @ src for 4 (x, y) correspondences."""
    src = jnp.asarray(src, jnp.float32)
    dst = jnp.asarray(dst, jnp.float32)
    rows = []
    rhs = []
    for i in range(4):
        x, y = src[i, 0], src[i, 1]
        u, v = dst[i, 0], dst[i, 1]
        rows.append(jnp.stack(
            [x, y, jnp.float32(1), jnp.float32(0), jnp.float32(0),
             jnp.float32(0), -x * u, -y * u]))
        rows.append(jnp.stack(
            [jnp.float32(0), jnp.float32(0), jnp.float32(0), x, y,
             jnp.float32(1), -x * v, -y * v]))
        rhs.extend([u, v])
    a = jnp.stack(rows)
    b = jnp.stack(rhs)
    h8 = jnp.linalg.solve(a, b)
    return jnp.concatenate([h8, jnp.ones(1, jnp.float32)]).reshape(3, 3)


def warp_perspective(
    img: jnp.ndarray, h_mat: jnp.ndarray, out_h: int, out_w: int
) -> jnp.ndarray:
    """out(p) = img(H^-1 p) bilinear (cv.warpPerspective semantics)."""
    hinv = jnp.linalg.inv(h_mat)
    ys = jax.lax.broadcasted_iota(jnp.float32, (out_h, out_w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (out_h, out_w), 1)
    ones = jnp.ones_like(xs)
    coords = jnp.stack([xs, ys, ones])                  # (3, H, W)
    # HIGHEST: a reduced-precision (TF32) product would round hinv's
    # entries enough to move sample points by ~1 px at 1920-px coordinates
    mapped = jnp.einsum("ij,jhw->ihw", hinv, coords,
                        precision=jax.lax.Precision.HIGHEST)
    sx = mapped[0] / mapped[2]
    sy = mapped[1] / mapped[2]
    return bilinear_sample(img.astype(jnp.float32), sx, sy)
