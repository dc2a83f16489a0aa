"""Runtime helpers: persistent compile cache and wall-clock timing.

Full pipeline steps take tens of seconds to compile cold, so every entry
point enables JAX's persistent compilation cache; warm runs then skip
compilation entirely.
"""

from __future__ import annotations

import os
import time

# <checkout>/.jax_cache, normalized: the cache path is part of the cache's
# identity, so it must not depend on how the package was imported.
_DEFAULT_CACHE = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                 ".jax_cache"))


def compilation_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_CACHE


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and this
    configures no other directory."""
    import jax

    cache = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache


class Timer:
    """Wall-clock span timer: with Timer() as t: ...; t.dt"""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dt = time.perf_counter() - self.t0
        return False
