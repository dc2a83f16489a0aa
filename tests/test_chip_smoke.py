"""chip_smoke.py / bench.py off the card: they refuse the CPU, fail
outside the repository, and their phase logic runs at tiny sizes."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_result_line(stdout: str) -> bool:
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    return bool(lines) and lines[-1].startswith("{")


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_cpu_backend(script):
    r = _run([script], ROOT)
    assert r.returncode != 0
    assert not _has_result_line(r.stdout)
    assert "no GPU" in r.stderr


def test_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert not _has_result_line(r.stdout)


def test_require_gpu_raises_on_cpu():
    from lk_tpu.utils.device import device_record, require_gpu

    assert device_record()["platform"] == "cpu"
    with pytest.raises(SystemExit):
        require_gpu()


@pytest.mark.parametrize("count", [1, 4])
def test_result_line(count):
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
           "count": count, "extra": "ignored"}
    line = chip_smoke.result_line(dev)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


def test_check_raises():
    chip_smoke.check(True, "fine")
    with pytest.raises(chip_smoke.SmokeFailure, match="broken"):
        chip_smoke.check(False, "broken")


def test_dense_phase_rehearsal(tmp_path, monkeypatch, capsys):
    """Phase 2's logic at a tiny size on the CPU (here both backends are
    the CPU, so the cross-backend diff is ~0)."""
    monkeypatch.setattr(chip_smoke, "OUT_DIR", str(tmp_path))
    out = chip_smoke.phase_dense(chip_smoke.Log("cpu"), h=96, w=128,
                                 n_frames=3, reps=2, trace=False)
    assert out["fps"] > 0 and out["compile_s"] > 0
    text = capsys.readouterr().out
    assert "mean EPE vs ground truth" in text
    assert "[cpu] dense 96x128 steady" in text


def test_four_card_phase_rehearsal(monkeypatch, capsys):
    """--four-cards' logic on 4 of the 8 virtual CPU devices, tiny sizes:
    data lands on every device and both paths match their one-device run."""
    import dataclasses

    from lk_tpu.models import PRESETS

    monkeypatch.setitem(PRESETS, "final",
                        dataclasses.replace(PRESETS["final"], width=128))
    chip_smoke.phase_four_cards(chip_smoke.Log("cpu"), streams=4, frames=9,
                                width=128, height=72, dense_hw=(64, 128),
                                dense_t=3)
    text = capsys.readouterr().out
    assert "4-card staging shards on 4 devices" in text
    assert "4-card dense stream-DP at 64x128" in text


def test_top_device_ops_of_empty_trace(tmp_path):
    assert chip_smoke.top_device_ops(str(tmp_path / "none")) == []
