"""The compile-cache rule: $JAX_COMPILATION_CACHE_DIR when set (and no
other directory configured), else the fixed <checkout>/.jax_cache."""

import os

import jax
import pytest

from lk_tpu.utils import runtime


@pytest.fixture
def config_calls(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_cache_follows_env_var(monkeypatch, tmp_path, config_calls):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert runtime.enable_compilation_cache() == str(tmp_path / "c")
    # JAX reads the variable itself: no directory is configured in code
    assert "jax_compilation_cache_dir" not in config_calls
    assert not (tmp_path / "c").exists()


def test_cache_defaults_to_checkout(monkeypatch, config_calls):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    got = runtime.enable_compilation_cache()
    assert got == want == os.path.normpath(got)
    assert config_calls["jax_compilation_cache_dir"] == want
    assert os.path.isdir(want)
