"""Gaussian smoothing & pyramids (replaces ``cv.GaussianBlur``/``cv.pyrDown``).

The reference blurs with a 3x3 sigma-0 Gaussian (reference LK_Final.py:416),
which OpenCV resolves to the separable [1,2,1]/4 kernel with BORDER_REFLECT_101
(verified bit-exact vs cv2 5.0).  ``cv.calcOpticalFlowPyrLK`` builds its
pyramid with pyrDown's [1,4,6,4,1]/16 kernel, REFLECT_101 border and even-pixel
decimation to size ceil(n/2) (verified bit-exact).

Implementation note: tiny separable stencils are written as shifted adds on a
reflect-padded array — XLA fuses these into a handful of elementwise loops,
and they vectorize across arbitrary leading batch dims for free.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import jax
import jax.numpy as jnp


def _reflect101_pad(x: jnp.ndarray, pad: int, axis: int) -> jnp.ndarray:
    """BORDER_REFLECT_101 padding (edge pixel not repeated): cba|abcd|cba."""
    pads = [(0, 0)] * x.ndim
    pads[axis] = (pad, pad)
    return jnp.pad(x, pads, mode="reflect")


def _sep_filter_axis(x: jnp.ndarray, taps: Sequence[float], axis: int) -> jnp.ndarray:
    """Correlate along `axis` with a small symmetric kernel, REFLECT_101 border."""
    k = len(taps)
    pad = k // 2
    xp = _reflect101_pad(x.astype(jnp.float32), pad, axis)
    n = x.shape[axis]
    out = None
    for i, t in enumerate(taps):
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(i, i + n)
        term = xp[tuple(sl)] * jnp.float32(t)
        out = term if out is None else out + term
    return out


def sep_filter2d(x: jnp.ndarray, taps: Sequence[float]) -> jnp.ndarray:
    """Separable 2-D filter over the trailing (H, W) axes."""
    y = _sep_filter_axis(x, taps, axis=-1)
    return _sep_filter_axis(y, taps, axis=-2)


_GAUSS3 = (0.25, 0.5, 0.25)
_GAUSS5 = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)


def gaussian_blur3(img: jnp.ndarray) -> jnp.ndarray:
    """3x3 sigma-0 Gaussian blur, float path (matches cv2 float32 bit-exact)."""
    return sep_filter2d(img, _GAUSS3)


@functools.lru_cache(maxsize=64)
def _pyr_col_matrix(w: int) -> np.ndarray:
    """(w, ceil(w/2)) matrix folding the 5-tap column filter, REFLECT_101
    border, and even-column decimation into one banded matmul."""
    w2 = -(-w // 2)
    m = np.zeros((w, w2), np.float32)
    for d in range(w2):
        for k, t in enumerate(_GAUSS5):
            i = 2 * d + k - 2
            if i < 0:
                i = -i
            if i >= w:
                i = 2 * w - 2 - i
            m[i, d] += np.float32(t)
    return m


def pyr_down(img: jnp.ndarray, fast: bool = False) -> jnp.ndarray:
    """One pyramid level down: 5-tap Gaussian + even-pixel decimation.

    Output spatial size is ceil(n/2) per axis, matching cv.pyrDown.

    Exact path: filter rows as shifted adds -> decimate rows (strided
    slice) -> filter+decimate columns as ONE banded matmul at HIGHEST
    precision (full f32).

    fast=True maps BOTH axes to banded matmuls at DEFAULT matmul precision:
    the row shifted-add pass and its full-height f32 intermediate
    disappear.  DEFAULT precision may round the matmul operands (TF32 on
    tensor-core GPUs: 10 mantissa bits, <= 0.25 intensity on 0..255
    images; exact f32 on the CPU) — fine for the coarse-search pyramid of
    dense LK, NOT for paths that promise cv.pyrDown bit-exactness (the
    default remains exact).
    """
    if fast:
        mr = jnp.asarray(_pyr_col_matrix(img.shape[-2]))
        mc = jnp.asarray(_pyr_col_matrix(img.shape[-1]))
        x = img.astype(jnp.float32)
        # rows: contract the H axis with the (H, H2) matrix
        y = jax.lax.dot_general(
            x, mr, (((x.ndim - 2,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        # dot_general moved the contracted-row result axis last: (..., W, H2)
        y = jnp.swapaxes(y, -1, -2)
        return jax.lax.dot_general(
            y, mc, (((y.ndim - 1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    x = _sep_filter_axis(img, _GAUSS5, axis=-2)
    sl = [slice(None)] * x.ndim
    sl[-2] = slice(None, None, 2)
    x = x[tuple(sl)]
    m = jnp.asarray(_pyr_col_matrix(x.shape[-1]))
    return jnp.matmul(x, m, precision=jax.lax.Precision.HIGHEST)


def gaussian_pyramid(img: jnp.ndarray, max_level: int) -> list[jnp.ndarray]:
    """List of max_level+1 images, level 0 = input (cv.buildOpticalFlowPyramid)."""
    levels = [img.astype(jnp.float32)]
    for _ in range(max_level):
        levels.append(pyr_down(levels[-1]))
    return levels
