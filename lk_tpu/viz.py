"""Visualization: the reference's plots and overlay accumulations, headless.

Replaces the live matplotlib window and post-run plots (reference
``plot_vp`` LK_Final.py:753-776, ``data_statistic`` LK_Final.py:728-739, the
``all_lines_frame`` accumulator LK_Final.py:504,563-564,713-719) with figure
factories that render to files — the pipelines run headless on
accelerator hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_vp_figure(
    vp_history: np.ndarray,
    cross_points: np.ndarray,
    vp: Optional[Tuple[float, float]],
    width: int,
    height: int,
    vl_lines: Optional[Sequence] = None,
    out_path: str = "vp_plot.png",
    window: int = 300,
) -> str:
    """The live CP/VP scatter (reference plot_vp): red center, yellow recent
    cross points, blue VP history, black current VP, optional VL lines."""
    plt = _plt()
    fig = plt.figure(figsize=(12, 8), dpi=80)
    plt.title(f"Recent {window} Points")
    plt.xlabel("x axis")
    plt.ylabel("y axis")
    plt.scatter(width / 2, height / 2, 100, "r")
    if len(cross_points):
        cp = np.asarray(cross_points)[-window:]
        plt.scatter(cp[:, 0], cp[:, 1], 10, "y")
    if len(vp_history):
        h = np.asarray(vp_history)[-window:]
        plt.scatter(h[:, 0], h[:, 1], 20, "b")
    if vp is not None:
        plt.scatter([vp[0]], [vp[1]], 100, "black")
    if vl_lines:
        for (a, b) in vl_lines:
            plt.plot([a[0], b[0]], [a[1], b[1]])
    plt.legend(["center", "cross points", "VPs history", "VP",
                "vanishing line"])
    # the reference keeps a fixed viewport (LK_Final.py:764-765); set limits
    # last so autoscale/axis('scaled') cannot override them
    plt.gca().set_aspect("equal")
    plt.xlim(width // 3, width // 3 * 2)
    plt.ylim(height // 4 * 3, height // 3)   # inverted y like the reference
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def vp_distribution_figure(
    xs: Sequence[float], ys: Sequence[float], width: int, height: int,
    out_path: str = "vp_distribution.png",
) -> str:
    """Offline VP-distribution scatter (reference data_statistic)."""
    plt = _plt()
    fig = plt.figure(figsize=(12, 8), dpi=80)
    plt.title("VP distribution")
    plt.xlim(0, width)
    plt.ylim(0, height)
    plt.xlabel("x")
    plt.ylabel("y")
    plt.scatter(xs, ys, 10)
    plt.gca().invert_yaxis()
    plt.axis("scaled")
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def all_lines_image(
    segments, width: int, height: int,
    vp: Optional[Tuple[float, float]] = None,
    out_path: str = "all_lines.png",
    seed: int = 0,
) -> str:
    """Accumulated flow-line frame (reference all_lines_frame) + center dot."""
    import cv2 as cv

    img = np.zeros((height, width, 3), np.uint8)
    rng = np.random.default_rng(seed)
    for s in segments:
        a = np.asarray(s["start"])
        b = np.asarray(s["stop"])
        color = tuple(int(c) for c in rng.integers(0, 255, 3))
        cv.line(img, (int(b[0]), int(b[1])), (int(a[0]), int(a[1])), color, 2)
    if vp is not None and np.isfinite(vp).all():
        cv.circle(img, (int(vp[0]), int(vp[1])), 2, (0, 255, 100), -1)
    cv.circle(img, (width // 2, height // 2), 6, (0, 0, 255), -1)
    cv.imwrite(out_path, img)
    return out_path
