"""Host-side u8 preprocessing: BGR->gray and INTER_AREA resize in numpy.

The serving and ``host_preprocess`` paths convert and shrink decoded frames
on the host and upload small u8 grays.  These reproduce
``cv.cvtColor(BGR2GRAY)`` and ``cv.resize(..., INTER_AREA)`` on uint8 bit for
bit (tests/test_io_staging.py checks both against cv2), so the main path
needs no OpenCV.
"""

from __future__ import annotations

import functools

import numpy as np

from lk_tpu.ops.color import _B, _G, _R, _SHIFT


def bgr_to_gray_u8(bgr: np.ndarray) -> np.ndarray:
    """(..., H, W, 3) u8 BGR -> (..., H, W) u8, cv2's fixed-point rule."""
    b = bgr[..., 0].astype(np.int32)
    g = bgr[..., 1].astype(np.int32)
    r = bgr[..., 2].astype(np.int32)
    y = (r * _R + g * _G + b * _B + (1 << (_SHIFT - 1))) >> _SHIFT
    return y.astype(np.uint8)


@functools.lru_cache(maxsize=32)
def _area_passes(n_src: int, n_dst: int) -> tuple:
    """cv2's INTER_AREA tap table for one axis, split into passes.

    Same cells and float32 weights as OpenCV's computeResizeAreaTab; pass r
    holds the r-th tap of every destination index, so accumulating the
    passes in order sums each destination's taps in OpenCV's order (which
    makes the float32 result, and hence the u8 rounding, identical)."""
    scale = 1.0 / (n_dst / n_src)
    di, si, al = [], [], []
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s2 = min(int(np.floor(f2)), n_src - 1)
        s1 = min(int(np.ceil(f1)), s2)
        if s1 - f1 > 1e-3:
            di.append(d)
            si.append(s1 - 1)
            al.append((s1 - f1) / cell)
        for s in range(s1, s2):
            di.append(d)
            si.append(s)
            al.append(1.0 / cell)
        if f2 - s2 > 1e-3:
            di.append(d)
            si.append(s2)
            al.append(min(f2 - s2, 1.0, cell) / cell)
    di = np.asarray(di)
    rank = np.zeros(len(di), np.int64)
    for i in range(1, len(di)):
        rank[i] = rank[i - 1] + 1 if di[i] == di[i - 1] else 0
    si = np.asarray(si)
    al = np.asarray(al, np.float32)
    return tuple((di[rank == r], si[rank == r], al[rank == r])
                 for r in range(int(rank.max()) + 1))


def resize_area_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W) u8 -> (height, width) u8, ``cv.resize(INTER_AREA)`` exactly."""
    h, w = img.shape
    if w % width == 0 and h % height == 0:
        # OpenCV's integer-factor path: exact integer block sums
        sx, sy = w // width, h // height
        s = img.reshape(height, sy, width, sx).astype(np.int32).sum((1, 3))
        if (sx, sy) == (2, 2):
            return ((s + 2) >> 2).astype(np.uint8)
        out = s.astype(np.float32) * np.float32(1.0 / (sx * sy))
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    src = img.astype(np.float32)
    buf = np.zeros((h, width), np.float32)
    for d, s, a in _area_passes(w, width):
        buf[:, d] += src[:, s] * a
    out = np.zeros((height, width), np.float32)
    for d, s, a in _area_passes(h, height):
        out[d] += buf[s] * a[:, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def stage_gray(bgr: np.ndarray, width: int, height: int) -> np.ndarray:
    """One decoded BGR frame -> the pipeline's u8 gray at (height, width)."""
    return resize_area_u8(bgr_to_gray_u8(bgr), width, height)
