"""Test configuration.

The CPU runs use 8 virtual devices for the multi-device sharding tests;
XLA_FLAGS must be set before the CPU client initializes. Tests that need
the card carry the `gpu` marker and skip elsewhere.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.1")

import jax
import numpy as np
import pytest

from ssnt_tts.utils.runtime import configure_compile_cache

configure_compile_cache()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time, so
    every xdist worker collects the same tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
    return jax.devices()[0]
