"""Windowed (box) sums — the LK structure-tensor accumulator.

OpenCV's LK window is an unweighted box (winSize=(15,15), reference
LK_Final.py:94).  For the dense flow path we need box-filtered sums of
gradient products over the whole frame, written as two separable shifted-add
passes (XLA does not separate NxN reduce_window windows — the naive form
costs win_h*win_w adds per pixel and dominated the dense-LK frame time).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def box_sum(
    x: jnp.ndarray, win: Tuple[int, int], border: str = "zero",
    sum_dtype=jnp.float32,
) -> jnp.ndarray:
    """SAME windowed sum over trailing (H, W) axes.

    win is (win_w, win_h) in OpenCV order.  border: "zero" (cheap; partial
    windows at the frame edge) or "reflect" (BORDER_REFLECT_101, matching
    OpenCV's boxFilter default — needed where border responses must match,
    e.g. the Shi–Tomasi response).

    Implemented as two separable shifted-add passes (win_h + win_w adds per
    pixel) rather than lax.reduce_window (win_h * win_w adds — XLA does not
    separate box windows; the 15x15 window is the dense-LK hot loop's single
    biggest cost when done naively).

    sum_dtype=bfloat16 halves the memory traffic of both passes (the op is
    bandwidth-bound at frame sizes); ~3 decimal digits survive the 15-term
    sums — callers must tolerate ~1e-2 relative error.  Output cast back to
    the input's float dtype (f32 for integer inputs).
    """
    win_w, win_h = win
    pad_h = ((win_h - 1) // 2, win_h // 2)
    pad_w = ((win_w - 1) // 2, win_w // 2)
    out_dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else (
        jnp.float32
    )
    x = x.astype(sum_dtype)
    mode = {"zero": "constant", "reflect": "reflect", "edge": "edge"}[border]

    def axis_sum(a: jnp.ndarray, k: int, pad, axis: int) -> jnp.ndarray:
        pads = [(0, 0)] * a.ndim
        pads[axis] = pad
        ap = jnp.pad(a, pads, mode=mode)
        n = a.shape[axis]
        out = None
        for i in range(k):
            sl = [slice(None)] * a.ndim
            sl[axis] = slice(i, i + n)
            term = ap[tuple(sl)]
            out = term if out is None else out + term
        return out

    y = axis_sum(x, win_h, pad_h, x.ndim - 2)
    return axis_sum(y, win_w, pad_w, x.ndim - 1).astype(out_dtype)
