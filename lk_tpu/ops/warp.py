"""Bilinear sampling / warping — the LK kernel's inner memory op.

Replaces OpenCV's fixed-point bilinear interpolation inside
``cv.calcOpticalFlowPyrLK`` (reference LK_Final.py:531) with float32 gathers.

Two access patterns, matching the two LK modes:

* ``bilinear_sample`` / ``warp_by_flow`` — arbitrary-coordinate gathers used by
  the dense flow field path (one gather per iteration over the whole frame).
* ``extract_patch`` — a (h+1, w+1) dynamic_slice plus 4-tap blend for
  per-point windows (the patch is tiny, so one contiguous slice suffices).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def bilinear_sample(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Sample ``img[(..., H, W)]`` at float coords (x, y), clamped to borders.

    x/y may have any (matching) shape; output has that shape (with img's
    leading batch dims broadcast by the caller via vmap if needed).
    """
    h, w = img.shape[-2], img.shape[-1]
    x = jnp.clip(x, 0.0, w - 1.0)
    y = jnp.clip(y, 0.0, h - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, w - 1)
    y1i = jnp.minimum(y0i + 1, h - 1)

    def at(yy, xx):
        return img[..., yy, xx]

    v00 = at(y0i, x0i)
    v01 = at(y0i, x1i)
    v10 = at(y1i, x0i)
    v11 = at(y1i, x1i)
    top = v00 + fx * (v01 - v00)
    bot = v10 + fx * (v11 - v10)
    return top + fy * (bot - top)


def warp_by_flow(img: jnp.ndarray, flow: jnp.ndarray) -> jnp.ndarray:
    """Warp: out(p) = img(p + flow(p)), bilinear, border-clamped.

    img: (H, W); flow: (H, W, 2) in (dx, dy) order.
    """
    h, w = img.shape[-2], img.shape[-1]
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    return bilinear_sample(img, xs + flow[..., 0], ys + flow[..., 1])


def extract_patch(
    img: jnp.ndarray, center: jnp.ndarray, win: Tuple[int, int]
) -> jnp.ndarray:
    """Bilinear patch of size (win_h, win_w) around float ``center`` = (x, y).

    The patch covers integer offsets [-half .. +half] from the subpixel
    center, i.e. the OpenCV LK window whose top-left is center - halfWin.
    Implemented as a (win_h+1, win_w+1) dynamic_slice + 4-tap blend.  The
    slice start is clamped by dynamic_slice semantics; callers must gate
    validity separately (see flow.sparse).
    """
    win_w, win_h = win
    x0f = center[0] - (win_w - 1) * 0.5
    y0f = center[1] - (win_h - 1) * 0.5
    x0 = jnp.floor(x0f)
    y0 = jnp.floor(y0f)
    fx = (x0f - x0).astype(img.dtype)
    fy = (y0f - y0).astype(img.dtype)
    raw = jax.lax.dynamic_slice(
        img,
        (y0.astype(jnp.int32), x0.astype(jnp.int32)),
        (win_h + 1, win_w + 1),
    )
    a = raw[:-1, :-1]
    b = raw[:-1, 1:]
    c = raw[1:, :-1]
    d = raw[1:, 1:]
    top = a + fx * (b - a)
    bot = c + fx * (d - c)
    return top + fy * (bot - top)
