"""Multi-host scale-out: 2-process CPU cluster via jax.distributed (gloo).

The reference is single-process (SURVEY.md §5.8); the framework's multi-host
story is stream-sharding across hosts with per-host decode.  This test launches
two real OS processes (tests/multihost_worker.py), each owning 2 CPU devices
of a global 4-device data mesh, and asserts the globally-sharded pipeline
reproduces the single-process baseline on the rows each host owns.
"""

import os
import socket
import subprocess
import sys

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_stream_sharded_pipeline():
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"MULTIHOST_OK {pid}" in out, out[-3000:]
    # each host owned a distinct, contiguous half of the stream batch
    assert "rows=0:4" in outs[0] and "rows=4:8" in outs[1]
