"""The main path needs neither OpenCV nor matplotlib: import it and run
the synthetic source and host staging with both blocked."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK = (
    "import sys\n"
    "sys.modules['cv2'] = None\n"
    "sys.modules['matplotlib'] = None\n"
    "sys.path.insert(0, {root!r})\n"
)


@pytest.mark.parametrize("body", [
    # every module of the serving / dense / app path
    "import bench, chip_smoke, __graft_entry__\n"
    "import lk_tpu, lk_tpu.apps.serve, lk_tpu.apps.final\n"
    "import lk_tpu.flow.dense, lk_tpu.pipeline.runner, lk_tpu.parallel\n",
    # the synthetic source + staging, end to end on the host
    "from lk_tpu.apps import serve\n"
    "a = serve.build_parser().parse_args(['--width', '96', '--height', "
    "'64', '--frames', '3'])\n"
    "u8 = serve.stage_u8([serve.scene(a, 0)], 3, 40, 60)\n"
    "assert u8.shape == (3, 1, 40, 60)\n"
    "from lk_tpu.io.staging import stage_gray\n"
    "from lk_tpu.io.video import SyntheticRoadStream\n"
    "g = stage_gray(SyntheticRoadStream(96, 64, n_frames=1).frame(0), 60, 40)\n"
    "assert g.shape == (40, 60)\n",
])
def test_main_path_without_cv2(body):
    code = _BLOCK.format(root=ROOT) + body + "print('ok')\n"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")
