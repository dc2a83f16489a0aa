"""Golden-trajectory regression: the full pipeline's VP CSV on a fixed
synthetic clip must not drift across refactors (the framework's analogue of
the reference's committed vps/*.csv artifacts, SURVEY.md §4).

Regenerate the golden files after an INTENDED semantics change with
``LK_TPU_REGEN_GOLDEN=1 python -m pytest tests/test_golden_trajectory.py``
(the diff then documents the drift for review)."""

import csv
import dataclasses
import os

import numpy as np

from lk_tpu.config import PipelineConfig
from lk_tpu.io.video import SyntheticRoadStream
from lk_tpu.pipeline.runner import VideoPipeline

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN = os.path.join(GOLDEN_DIR, "vps_synthetic_seed42.csv")
REGEN = os.environ.get("LK_TPU_REGEN_GOLDEN") == "1"


def _check_or_regen(path, got, header):
    got = np.asarray(got, np.float64).reshape(-1, 2)
    if REGEN or not os.path.exists(path):
        with open(path, "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(header)
            for x, y in got:
                wr.writerow([f"{x:.6f}", f"{y:.6f}"])
        assert REGEN, f"golden {path} was missing; generated — commit it"
        return
    with open(path) as f:
        rows = list(csv.reader(f))[1:]
    want = np.array([[float(a), float(b)] for a, b in rows], np.float64)
    assert len(got) == len(want), (len(got), len(want))
    np.testing.assert_allclose(got, want, atol=0.05)


def test_vp_trajectory_matches_golden():
    scene = SyntheticRoadStream(width=860, height=484, zoom=1.03, seed=42,
                                n_frames=36)
    pipe = VideoPipeline(PipelineConfig(), src_size=(860, 484), chunk=8)
    pipe.run(iter(scene))
    # float drift tolerance; row count and trajectory shape must be identical
    _check_or_regen(GOLDEN, pipe.csv_rows, ["x", "y"])


def _multievent_frames():
    """Three scene phases with distinct VPs: drives init -> track -> scene
    jump -> hide -> re-init TWICE, the full VP-lifecycle event chain."""
    phases = [((160, 100), 3), ((270, 120), 9), ((205, 140), 5)]
    frames = []
    for vp, seed in phases:
        s = SyntheticRoadStream(width=430, height=242, zoom=1.05, seed=seed,
                                n_frames=40, vp=vp)
        frames += [s.frame(t) for t in range(40)]
    return frames


def _vp_trace(pipe):
    """vp_per_frame as (x, y) rows with (nan, nan) hidden markers — pins
    WHEN the VP hid and re-initialized, not just the shown values."""
    return [(v if v is not None else (np.nan, np.nan))
            for v in pipe.vp_per_frame]


def _run_multievent(cfg_base, tag):
    cfg = dataclasses.replace(cfg_base, width=430, hide_vp_thold=10)
    pipe = VideoPipeline(cfg, src_size=(430, 242), chunk=10)
    pipe.run(iter(_multievent_frames()))
    vpf = pipe.vp_per_frame
    hid = [i for i, v in enumerate(vpf) if v is None and i > 30]
    # semantic gates first (so a regen can't silently pin a broken run):
    # the VP must hide after BOTH scene jumps and re-initialize after each
    assert any(40 < i <= 80 for i in hid), "no hide after first jump"
    assert any(i > 80 for i in hid), "no hide after second jump"
    last_hid = max(hid)
    settled = np.array([v for v in vpf[last_hid + 1:] if v is not None])
    assert len(settled) > 5, "VP never re-initialized after the last hide"
    err = np.linalg.norm(settled[len(settled) // 2:].mean(0) - (205, 140))
    assert err < 30, err
    _check_or_regen(
        os.path.join(GOLDEN_DIR, f"vps_multievent_{tag}.csv"),
        pipe.csv_rows, ["x", "y"])
    trace = np.array(_vp_trace(pipe), np.float64)
    _check_or_regen(
        os.path.join(GOLDEN_DIR, f"vpf_multievent_{tag}.csv"),
        np.nan_to_num(trace, nan=-1.0), ["x", "y"])


def test_vp_multievent_golden_final_preset():
    """hide -> re-init chain under the FINAL preset (vp_init_aliasing=True:
    every re-init exercises the LK_Final.py:576-577 alias quirk)."""
    from lk_tpu.models import FINAL

    assert FINAL.vp_init_aliasing
    _run_multievent(FINAL, "final")


def test_vp_multievent_golden_classify_preset():
    """Same event chain under CLASSIFY (LK3: vp_init_aliasing=False,
    EXT update method, update-after-test EMA order) — pins the alias-OFF
    lifecycle and the other EMA order through the same events."""
    from lk_tpu.models import CLASSIFY

    assert not CLASSIFY.vp_init_aliasing
    _run_multievent(CLASSIFY, "classify")
