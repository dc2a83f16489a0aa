"""Video ingest: file decode (OpenCV backend) and synthetic dashcam streams.

Only ``VideoReader`` needs OpenCV (imported when a file is opened); the
synthetic source is numpy/scipy.

Replaces the reference's ``cv.VideoCapture`` loop (reference
LK_Final.py:79,425,509-517).  The synthetic generator produces a forward-
driving scene with a known ground-truth vanishing point — the golden source
for end-to-end tests and benchmarks (the reference's GRMN clips are not in
the snapshot; only their vps/*.csv outputs are).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np


class VideoReader:
    """Sequential BGR frame reader over a file (cv2 backend).

    Exposes (width, height) props like VideoCapture (LK_Final.py:426-428).
    """

    def __init__(self, path: str):
        import cv2 as cv

        self.cap = cv.VideoCapture(path)
        if not self.cap.isOpened():
            raise RuntimeError(f"Could not open video {path!r}")
        self.width = int(self.cap.get(cv.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv.CAP_PROP_FRAME_HEIGHT))
        self.fps = float(self.cap.get(cv.CAP_PROP_FPS) or 30.0)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            ret, frame = self.cap.read()
            if not ret:
                break
            yield frame

    def close(self):
        self.cap.release()


def _reflect101(idx: np.ndarray, n: int) -> np.ndarray:
    """BORDER_REFLECT_101 index map (dcb|abcd|cba) for any integer index."""
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def _lerp_axis(src: np.ndarray, coords: np.ndarray, axis: int) -> np.ndarray:
    """Linear interpolation of ``src`` at float ``coords`` along ``axis``
    with REFLECT_101 borders (one factor of a separable bilinear warp)."""
    c0 = np.floor(coords)
    frac = (coords - c0).astype(np.float32)
    c0 = c0.astype(np.int64)
    n = src.shape[axis]
    lo = np.take(src, _reflect101(c0, n), axis=axis)
    hi = np.take(src, _reflect101(c0 + 1, n), axis=axis)
    shape = [1] * src.ndim
    shape[axis] = len(coords)
    frac = frac.reshape(shape)
    return lo + frac * (hi - lo)


class SyntheticRoadStream:
    """Forward-driving scene: texture expanding radially from a fixed VP.

    frame_{t}(p) = texture(vp + (p - vp) / zoom^t): every feature streams
    away from the vanishing point, downward in the lower half — matching the
    dashcam geometry the reference's ROI/angle filters assume.

    Pure numpy/scipy: the texture is two Gaussian-blurred noise layers
    (REFLECT_101 borders, the cv.GaussianBlur default) and each frame is an
    exact bilinear resample of it.  A zoom about the VP is axis-aligned, so
    the resample is separable (rows, then columns).
    """

    def __init__(
        self,
        width: int = 1280,
        height: int = 720,
        vp: Optional[Tuple[float, float]] = None,
        zoom: float = 1.02,
        seed: int = 0,
        n_frames: int = 120,
        color: bool = True,
    ):
        from scipy.ndimage import gaussian_filter

        self.width = width
        self.height = height
        self.n_frames = n_frames
        self.zoom = zoom
        self.color = color
        self.vp = vp if vp is not None else (width * 0.5, height * 0.45)
        rng = np.random.default_rng(seed)
        pad = 1.6  # texture bigger than the frame so zoom-out stays in bounds
        th, tw = int(height * pad), int(width * pad)
        tex = gaussian_filter(rng.random((th, tw)).astype(np.float32) * 255,
                              1.5, mode="mirror")
        tex += gaussian_filter(rng.random((th, tw)).astype(np.float32) * 255,
                               6.0, mode="mirror")
        tex = (tex - tex.min()) / (tex.max() - tex.min()) * 255
        self.tex = tex
        self.tex_off = ((tw - width) / 2.0, (th - height) / 2.0)

    def frame_gray(self, t: int) -> np.ndarray:
        """(H, W) u8 gray frame t (what ``frame`` stacks into BGR)."""
        scale = self.zoom ** (-t)
        vx, vy = self.vp
        ox, oy = self.tex_off
        # output pixel p -> texture coord vp_tex + (p - vp) * scale
        ys = np.arange(self.height) * scale + ((1 - scale) * vy + oy)
        xs = np.arange(self.width) * scale + ((1 - scale) * vx + ox)
        gray = _lerp_axis(_lerp_axis(self.tex, ys, 0), xs, 1)
        return np.clip(gray, 0, 255).astype(np.uint8)

    def frame(self, t: int) -> np.ndarray:
        g8 = self.frame_gray(t)
        if self.color:
            return np.stack([g8, g8, g8], axis=-1)
        return g8

    def __iter__(self) -> Iterator[np.ndarray]:
        for t in range(self.n_frames):
            yield self.frame(t)


def open_stream(spec: str, **kw):
    """"synthetic" or a file path -> frame iterable with width/height attrs."""
    if spec == "synthetic":
        return SyntheticRoadStream(**kw)
    if not os.path.exists(spec):
        raise FileNotFoundError(spec)
    return VideoReader(spec)
