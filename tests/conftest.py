"""Test configuration: run on a virtual 8-device CPU mesh.

Tests exercise the same jitted code as the card, on the CPU backend with 8
virtual devices so sharding tests work anywhere.  Flags must be set before
jax initializes.  Tests marked ``gpu`` need the card and skip elsewhere;
run them on a GPU machine with ``JAX_PLATFORMS=cuda,cpu python -m pytest
-m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The default device when it is a GPU; skips the test otherwise
    (decided here, at run time, never at import or collection)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; default backend is {dev.platform}")
    return dev
