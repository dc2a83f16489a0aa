"""Seeded flow-gate scenes with exact ground truth (numpy/scipy only).

A scene is a smooth two-octave noise texture moved by a fixed affine map
per frame: ``frames[k] = texture o M^-k``, so every consecutive pair
(frames[k], frames[k+1]) has the exact flow ``M p - p`` at each pixel p of
frames[k].  Translation (M = shift) is the lateral-pan regime; zoom plus a
slight rotation about the frame centre is the forward dashcam ego-motion
regime (divergent flow).  Used by bench.py's accuracy gate, chip_smoke.py
and the dense-flow tests.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np


class Scene(NamedTuple):
    frames: np.ndarray                        # (T, H, W) float32, 0..255
    gt: Callable[[np.ndarray], np.ndarray]    # (N, 2) x,y pts -> (N, 2) flow
    m: np.ndarray                             # (2, 3) per-frame forward map


def texture(rng: np.random.Generator, h: int, w: int,
            sigmas=(2.0, 8.0)) -> np.ndarray:
    """Two Gaussian-blurred noise layers (REFLECT_101 borders), 0..255."""
    from scipy.ndimage import gaussian_filter

    img = gaussian_filter(rng.random((h, w)).astype(np.float32) * 255,
                          sigmas[0], mode="mirror")
    img += gaussian_filter(rng.random((h, w)).astype(np.float32) * 255,
                           sigmas[1], mode="mirror")
    return ((img - img.min()) / (img.max() - img.min()) * 255).astype(
        np.float32)


def shift_map(dx: float, dy: float) -> np.ndarray:
    return np.array([[1.0, 0.0, dx], [0.0, 1.0, dy]])


def zoom_rot_map(h: int, w: int, scale: float, angle_deg: float) -> np.ndarray:
    """cv.getRotationMatrix2D((w/2, h/2), angle_deg, scale)."""
    a = math.radians(angle_deg)
    al, be = scale * math.cos(a), scale * math.sin(a)
    cx, cy = w / 2.0, h / 2.0
    return np.array([[al, be, (1 - al) * cx - be * cy],
                     [-be, al, be * cx + (1 - al) * cy]])


def affine_scene(rng: np.random.Generator, h: int, w: int, m: np.ndarray,
                 n_frames: int = 2, margin: int = 64) -> Scene:
    """``n_frames`` exact bilinear resamples of one texture, each frame
    moved by the forward affine ``m`` (2x3) from the last.  The texture
    extends ``margin`` px past the frame on every side so content moving
    in from the border is real texture, not a reflection."""
    from scipy.ndimage import map_coordinates

    tex = texture(rng, h + 2 * margin, w + 2 * margin)
    m3 = np.vstack([np.asarray(m, np.float64), [0.0, 0.0, 1.0]])
    inv = np.linalg.inv(m3)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    pts = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
    frames = np.empty((n_frames, h, w), np.float32)
    a = np.eye(3)
    for k in range(n_frames):
        q = a @ pts                       # frame-k pixel -> texture coords
        frames[k] = map_coordinates(
            tex, [q[1] + margin, q[0] + margin], order=1,
            mode="mirror").reshape(h, w)
        a = a @ inv

    def gt(p: np.ndarray) -> np.ndarray:
        p = np.asarray(p, np.float64)
        return (p @ m3[:2, :2].T + m3[:2, 2] - p).astype(np.float32)

    return Scene(frames=frames, gt=gt, m=np.asarray(m, np.float64))


def grid_points(h: int, w: int, margin: int = 40,
                step: int = 16) -> np.ndarray:
    """(N, 2) float32 x, y of a regular grid ``margin`` px inside the frame:
    the gate's evaluation points (away from border effects)."""
    ys, xs = np.mgrid[margin:h - margin:step, margin:w - margin:step]
    return np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)


def flow_at(flow: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """(N, 2) flow vectors of a dense (H, W, 2) field at integer ``pts``."""
    return flow[pts[:, 1].astype(int), pts[:, 0].astype(int)]


def grid_epe(flow: np.ndarray, gt: Callable[[np.ndarray], np.ndarray],
             margin: int = 40, step: int = 16) -> float:
    """Mean end-point error of a dense (H, W, 2) flow vs the exact flow
    ``gt`` over ``grid_points``."""
    pts = grid_points(flow.shape[0], flow.shape[1], margin, step)
    return float(np.linalg.norm(flow_at(flow, pts) - gt(pts), axis=1).mean())
