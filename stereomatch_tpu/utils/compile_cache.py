"""Persistent compilation cache placement, shared by every entry point.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory.  Otherwise the cache goes to ``.jax_cache/`` at
the root of the checkout (listed in ``.gitignore``): a fixed path, because
the path is part of what makes a cached program found again.  Programs are
cached whatever their compile time (JAX's default skips those under a
second, which is most of this program's one-frame pipelines).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> Path:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return Path(env)
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return CHECKOUT_CACHE
