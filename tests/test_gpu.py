"""Card-only checks (marker ``gpu``; they skip without a GPU).

Run on a GPU machine with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/``; chip_smoke.py covers the same paths at full size.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def test_dense_1080p_gate_on_card(gpu):
    """Default dense video chain at 1080p on the card: EPE gate and the
    CPU backend of the same process agree."""
    from lk_tpu.flow.dense import dense_pyramidal_lk_video
    from lk_tpu.io.scenes import affine_scene, grid_epe, zoom_rot_map

    h, w = 1080, 1920
    sc = affine_scene(np.random.default_rng(0), h, w,
                      zoom_rot_map(h, w, 1.004, 0.3), n_frames=2)
    fn = jax.jit(lambda f: dense_pyramidal_lk_video(f).flow)
    flow = np.asarray(fn(jax.device_put(sc.frames, gpu)))[0]
    assert grid_epe(flow, sc.gt) < 0.1
    ref = np.asarray(fn(jax.device_put(sc.frames, jax.devices("cpu")[0])))[0]
    d = np.linalg.norm(flow - ref, axis=-1)[16:-16, 16:-16]
    assert d.mean() < 1e-3 and d.max() < 0.05


def test_default_matmul_precision_is_reduced_on_card(gpu):
    """DEFAULT f32 matmuls on the card round operands (TF32), HIGHEST
    does not — the premise of pyr_down(fast=True)'s documented budget."""
    x = jnp.asarray(np.full((64, 64), 1.0 + 2.0 ** -15, np.float32))
    eye = jnp.eye(64, dtype=jnp.float32)
    exact = np.asarray(jnp.matmul(x, eye, precision=jax.lax.Precision.HIGHEST))
    assert np.all(exact == np.float32(1.0 + 2.0 ** -15))
    fast = np.asarray(jnp.matmul(x, eye))
    assert np.abs(fast - 1.0).max() < 2.0 ** -14
