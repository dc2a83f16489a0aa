"""What the program ran on: JAX's device record and the card's own reading.

Every speed number names its device (platform, kind, count) and, on a GPU,
the card's name and power limit as ``nvidia-smi`` reports them: a card set
below its maximum power limit runs slower under load.  Measurement paths
call :func:`require_gpu` and stop — they never fall back to the CPU.
"""

from __future__ import annotations

import shutil
import subprocess


def device_record() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's default backend."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """The device record, or SystemExit when JAX's default backend is not
    a GPU (a CPU run can measure nothing about the card)."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {rec['platform']!r} "
            f"({rec['kind']}); refusing to run on it")
    return rec


def card_reading(query: str = "name,power.limit") -> str:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader`` (first card),
    from a child process that stays off JAX."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    try:
        out = subprocess.run(
            [exe, f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[0] if lines else "nvidia-smi: no output"
