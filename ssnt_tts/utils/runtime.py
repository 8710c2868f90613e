"""Process set-up shared by the entry points: the persistent compile cache,
the accelerator check, and the card's identity.

Every entry point (`chip_smoke.py`, `bench.py`, `scripts/train.py`,
`__graft_entry__.py`, the test suite) calls `configure_compile_cache()`
before its first compilation.
"""

from __future__ import annotations

import os
import subprocess

import jax

# Inside the checkout and listed in .gitignore. The path is part of the
# cache key, so it is fixed rather than per-run.
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def configure_compile_cache() -> str:
    """Persist compiled programs across processes. Where
    JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and this leaves
    it alone; otherwise the cache goes to `DEFAULT_CACHE_DIR`. Returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu():
    """The first JAX device, which must be a GPU. Measurement paths call
    this instead of falling back to the CPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform} "
            f"({dev.device_kind}); this program only measures on a GPU"
        )
    return dev


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi`'s one-line name and power limit of each card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
