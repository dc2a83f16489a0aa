"""Benchmark: dense pyramidal LK at 1080p, frames/s on one GPU (+ EPE gate).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"card", "gate"}.  ``device`` is JAX's record (platform, device_kind,
count); ``card`` is ``nvidia-smi``'s name and power limit.  Without a GPU
the script exits non-zero and prints no result.

vs_baseline compares against the reference's only measured number — 27 fps
for its full SPARSE 20-point pipeline on a desktop CPU (BASELINE.md) — while
this measures DENSE per-pixel flow at 1080p: apples to oranges by necessity.

Accuracy gate: the reported throughput only counts if the WORST gate term
stays under 0.1 px — per scene (translation / zoom+rotation) the mean EPE
vs exact ground truth, and vs OpenCV's calcOpticalFlowPyrLK on
oracle-reliable points when OpenCV is installed.  Terms that cannot run
(no OpenCV; the natural-image scene, whose image is not in the repository)
are reported as "not run"; otherwise the benchmark reports 0.

Timing: the production video form (dense_pyramidal_lk_video) over a
CLIP_T-frame clip, host clock around block_until_ready after warm-up,
median of REPS.
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from lk_tpu.utils import enable_compilation_cache

enable_compilation_cache()

import jax
import jax.numpy as jnp

from lk_tpu.config import DenseLKConfig, LKConfig
from lk_tpu.flow.dense import dense_pyramidal_lk_video
from lk_tpu.io.scenes import (affine_scene, flow_at, grid_points, shift_map,
                              zoom_rot_map)

# The shipped benchmark is 1080p; LK_BENCH_H/W exist for resolution curves.
H = int(os.environ.get("LK_BENCH_H", "1080"))
W = int(os.environ.get("LK_BENCH_W", "1920"))
REPS = int(os.environ.get("LK_BENCH_REPS", "7"))
CLIP_T = 17
BASELINE_FPS = 27.0  # reference full pipeline on CPU (BASELINE.md)
GATE = 0.1
NOT_RUN = "not run"


def _flow_pair(dcfg: DenseLKConfig, a: np.ndarray, b: np.ndarray):
    """Flow of one pair through the production video chain."""
    fn = jax.jit(lambda fr: dense_pyramidal_lk_video(fr, LKConfig(),
                                                     dcfg).flow[0])
    return np.asarray(fn(jnp.asarray(np.stack([a, b]))))


def epe_check(dcfg: DenseLKConfig, img, nxt, gt):
    """Accuracy of the production program on one (img, nxt) scene pair:
    returns (mean EPE vs cv.calcOpticalFlowPyrLK on oracle-reliable points
    or NOT_RUN without OpenCV, mean EPE vs exact ground truth).

    The parity term counts only points where the ORACLE itself is within
    0.3 px of the exact answer (cv2's own error would otherwise be charged
    to this implementation); the ground-truth term covers every grid
    point, or every cv2-successful point when OpenCV ran."""
    flow = _flow_pair(dcfg, img, nxt)
    pts = grid_points(H, W)
    ours = flow_at(flow, pts)
    gtv = gt(pts)
    try:
        import cv2 as cv
    except ImportError:
        return NOT_RUN, float(np.linalg.norm(ours - gtv, axis=1).mean())
    p1, st, _ = cv.calcOpticalFlowPyrLK(
        img.astype(np.uint8), nxt.astype(np.uint8),
        pts.reshape(-1, 1, 2), None, winSize=(15, 15), maxLevel=2,
        criteria=(cv.TERM_CRITERIA_EPS | cv.TERM_CRITERIA_COUNT, 10, 0.03),
    )
    cv_flow = p1.reshape(-1, 2) - pts
    st = st.reshape(-1).astype(bool)
    sane = st & (np.linalg.norm(cv_flow - gtv, axis=1) < 0.3)
    epe_cv = float(np.linalg.norm(ours[sane] - cv_flow[sane], axis=1).mean())
    epe_gt = float(np.linalg.norm(ours[st] - gtv[st], axis=1).mean())
    return epe_cv, epe_gt


def gate_terms(dcfg: DenseLKConfig, rng) -> dict:
    """{scene: {"vs_cv2": px | NOT_RUN, "vs_gt": px | NOT_RUN}}."""
    terms = {}
    for name, m in (("shift", shift_map(3.7, -2.2)),
                    ("zoom+rot", zoom_rot_map(H, W, 1.004, 0.3))):
        sc = affine_scene(rng, H, W, m, n_frames=2)
        epe_cv, epe_gt = epe_check(dcfg, sc.frames[0], sc.frames[1], sc.gt)
        terms[name] = {"vs_cv2": epe_cv, "vs_gt": epe_gt}
    terms["natural"] = {"vs_cv2": NOT_RUN, "vs_gt": NOT_RUN}
    return terms


def worst_term(terms: dict) -> float:
    vals = [v for t in terms.values() for v in t.values() if v != NOT_RUN]
    return max(vals)


def throughput(dcfg: DenseLKConfig) -> float:
    """Steady frames/s of the video chain: median over REPS timed calls."""
    rng = np.random.default_rng(3)
    clip = affine_scene(rng, H, W, shift_map(1.3, -0.7),
                        n_frames=CLIP_T).frames
    frames = jnp.asarray(clip)
    run = jax.jit(lambda fr: dense_pyramidal_lk_video(fr, LKConfig(),
                                                      dcfg).flow)
    for _ in range(2):                       # compile + warm
        run(frames).block_until_ready()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        run(frames).block_until_ready()
        times.append(time.perf_counter() - t0)
    return (CLIP_T - 1) / statistics.median(times)


def main():
    from lk_tpu.utils.device import card_reading, require_gpu

    device = require_gpu()
    dcfg = DenseLKConfig()
    terms = gate_terms(dcfg, np.random.default_rng(1234))
    worst = worst_term(terms)
    fps = throughput(dcfg) if worst < GATE else 0.0
    print(json.dumps({
        "metric": "dense_pyramidal_lk_1080p_fps",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / BASELINE_FPS,
        "device": device,
        "card": card_reading(),
        "gate": {"terms_px": terms, "worst_px": worst, "limit_px": GATE},
    }))


if __name__ == "__main__":
    main()
