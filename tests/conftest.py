"""Test harness setup: force the CPU backend with 8 virtual devices so the
multi-device sharding paths are exercised without GPUs (the reference has no
analog of this; see SURVEY.md section 4).  The config updates also cover an
interpreter that imported jax before this file ran.

Tests that need a GPU take the ``gpu`` fixture below (marker ``gpu``); it
decides at run time, never at import, so every pytest-xdist worker collects
the same tests.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

# Persistent compilation cache: the suite is compile-bound (many small jitted
# programs), so repeat runs are much faster with a low entry threshold.
from admmnet_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first device, skipping the test unless it is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; found {dev.platform}")
    return dev
