"""Persistent XLA compilation cache location.

Every program here compiles in seconds to minutes on first use, so entry
points share one on-disk cache.  The cache key includes the directory, so it
must not move between runs: either the directory the environment names, or a
fixed path inside the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".cache" / "jax"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a stable directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing
    is changed here; otherwise ``<checkout>/.cache/jax`` is used.  Returns
    the directory in use.  Call before the first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
