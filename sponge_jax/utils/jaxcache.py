"""Where JAX keeps its persistent compilation cache for this checkout.

The one place that configures the cache.  ``JAX_COMPILATION_CACHE_DIR``, if
set, wins and nothing else is set; otherwise the cache lives at a fixed
path inside the checkout (``.jax_cache``, git-ignored), so a second run of
the same code finds what the first compiled.  The CPU test suite does not
call this and runs without a persistent cache (tests/conftest.py).
"""

from __future__ import annotations

import os
import pathlib

CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = str(CHECKOUT_CACHE)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
