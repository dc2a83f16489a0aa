"""CPU smoke of bench.py's accuracy-gate machinery (otherwise exercised
only on the card): the dual epe_check terms, the oracle-sane filter, and
the terms reported as not run."""

import importlib
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lk_tpu.config import DenseLKConfig  # noqa: E402
from lk_tpu.io.scenes import affine_scene, shift_map  # noqa: E402


@pytest.fixture
def small_bench(monkeypatch):
    """bench imported at a small geometry, robust to import order: the
    module reads LK_BENCH_H/W at load, so set the env and (re)load."""
    monkeypatch.setenv("LK_BENCH_H", "240")
    monkeypatch.setenv("LK_BENCH_W", "320")
    import bench

    bench = importlib.reload(bench)
    yield bench
    # restore the default-geometry module state for any later importer
    monkeypatch.delenv("LK_BENCH_H")
    monkeypatch.delenv("LK_BENCH_W")
    importlib.reload(bench)


def test_epe_check_dual_terms_small_geometry(small_bench, rng):
    bench = small_bench
    assert bench.H == 240 and bench.W == 320
    dcfg = DenseLKConfig()
    sc = affine_scene(rng, bench.H, bench.W, shift_map(2.0, -1.5))
    epe_cv, epe_gt = bench.epe_check(dcfg, sc.frames[0], sc.frames[1], sc.gt)
    assert np.isfinite(epe_cv) and np.isfinite(epe_gt)
    # pure translation on smooth texture: both terms well under the gate
    assert epe_cv < 0.1, epe_cv
    assert epe_gt < 0.1, epe_gt


def test_gate_reports_terms_it_cannot_run(small_bench, rng, monkeypatch):
    """Without OpenCV the cv2 terms read "not run" (never dropped), the
    natural scene is always "not run", and the worst term ignores them."""
    bench = small_bench
    monkeypatch.setitem(sys.modules, "cv2", None)
    terms = bench.gate_terms(DenseLKConfig(), rng)
    assert set(terms) == {"shift", "zoom+rot", "natural"}
    assert terms["natural"] == {"vs_cv2": "not run", "vs_gt": "not run"}
    for name in ("shift", "zoom+rot"):
        assert terms[name]["vs_cv2"] == "not run"
        assert terms[name]["vs_gt"] < 0.1
    assert bench.worst_term(terms) == max(
        terms[n]["vs_gt"] for n in ("shift", "zoom+rot"))


@pytest.mark.parametrize("margin,step", [(40, 16), (8, 8)])
def test_grid_epe_reads_exact_and_offset_flow(rng, margin, step):
    """grid_epe is 0 on the exact flow field and equals a constant error's
    length when every vector is off by the same amount."""
    from lk_tpu.io.scenes import grid_epe, grid_points, zoom_rot_map

    h, w = 120, 200
    sc = affine_scene(rng, h, w, zoom_rot_map(h, w, 1.01, 0.5))
    ys, xs = np.mgrid[0:h, 0:w]
    exact = sc.gt(np.stack([xs, ys], -1).reshape(-1, 2)).reshape(h, w, 2)
    assert grid_epe(exact, sc.gt, margin, step) == 0.0
    off = exact + np.array([0.3, -0.4], np.float32)
    assert abs(grid_epe(off, sc.gt, margin, step) - 0.5) < 1e-5
    pts = grid_points(h, w, margin, step)
    assert pts.min() >= margin and pts[:, 0].max() < w - margin
    assert pts[:, 1].max() < h - margin
