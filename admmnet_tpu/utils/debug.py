"""Numerical-debug helpers (SURVEY.md section 5: the JAX-native stand-in for
race detectors/sanitizers the single-controller model doesn't need).

- ``nan_guard()``: context manager enabling jax_debug_nans so the first NaN
  raises at the producing op instead of corrupting downstream state;
- ``check_finite(tree)``: host-side finiteness check of a fetched pytree,
  raising with the offending path;
- ``donation_safe(fn)``: marker wrapper asserting a function's outputs do not
  alias its (potentially donated) inputs after a roundtrip.
"""

from __future__ import annotations

import contextlib
from typing import Any

import numpy as np


@contextlib.contextmanager
def nan_guard():
    import jax

    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def check_finite(tree: Any, name: str = "tree") -> None:
    """Raise FloatingPointError naming the first non-finite leaf."""
    import jax

    host = jax.device_get(tree)
    leaves_with_paths = jax.tree_util.tree_flatten_with_path(host)[0]
    for path, leaf in leaves_with_paths:
        arr = np.asarray(leaf)
        if arr.dtype.kind in "fc" and not np.all(np.isfinite(arr)):
            bad = int(np.sum(~np.isfinite(arr)))
            raise FloatingPointError(
                f"{name}{jax.tree_util.keystr(path)}: {bad}/{arr.size} "
                f"non-finite values"
            )
