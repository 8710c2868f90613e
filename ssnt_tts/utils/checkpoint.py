"""Checkpoint / resume as one NumPy `.npz` file per step.

The reference is stateless step kernels — all decode state threads through
op inputs/outputs (SURVEY.md §5). That explicit-state design carries over:
the decode carry and TrainState are plain pytrees, so a checkpoint is the
flattened pytree, one array per leaf keyed by its tree path. Training
checkpoints hold {step, params, opt_state}.

Files are `<directory>/ckpt_<step>.npz`, written to a temporary name and
renamed into place, so a reader never sees a partial file. `save` keeps the
newest `max_to_keep` and deletes the rest.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import jax
import numpy as np

_NAME = re.compile(r"^ckpt_(\d+)\.npz$")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:010d}.npz")


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    found = (_NAME.match(n) for n in os.listdir(directory))
    return sorted(int(m.group(1)) for m in found if m)


def _flatten(state: Any):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(state)
    return [(jax.tree_util.keystr(p), x) for p, x in leaves], treedef


def save(directory: str, step: int, state: Any, max_to_keep: int = 3):
    """Save a pytree (TrainState or decode carry) at `step`."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    named, _ = _flatten(jax.device_get(state))
    arrays = {k: np.asarray(x) for k, x in named}
    final = _path(directory, step)
    tmp = final + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, final)
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))


def restore(directory: str, state_like: Any, step: Optional[int] = None):
    """Restore into the structure of `state_like` (shapes/dtypes template).

    step=None restores the latest checkpoint. Returns the restored pytree
    with NumPy leaves."""
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    named, treedef = _flatten(state_like)
    with np.load(_path(directory, step)) as data:
        stored = set(data.files)
        wanted = {k for k, _ in named}
        if stored != wanted:
            raise ValueError(
                f"checkpoint step {step} does not match the template: "
                f"missing {sorted(wanted - stored)}, "
                f"unexpected {sorted(stored - wanted)}"
            )
        leaves = []
        for k, like in named:
            x = data[k]
            dtype = np.dtype(like.dtype)
            if x.dtype.kind == "V" and x.dtype.itemsize == dtype.itemsize:
                # Extension dtypes (bfloat16) come back as raw bytes.
                x = x.view(dtype)
            if x.dtype != dtype or x.shape != tuple(like.shape):
                raise ValueError(
                    f"{k}: stored {x.dtype}{list(x.shape)}, template "
                    f"{dtype}{list(like.shape)}"
                )
            leaves.append(x)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(os.path.abspath(directory))
    return steps[-1] if steps else None
