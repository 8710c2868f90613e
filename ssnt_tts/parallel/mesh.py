"""Device mesh + sharding layout.

The reference's only parallelism is rayon shared-memory data parallelism over
the batch (SURVEY.md §2 parallelism table). The JAX equivalent is a 2-D
`jax.sharding.Mesh` ("data", "model"):

  - batch axes of activations shard over "data" (DP over NVLink/network; gradient
    psum inserted by XLA from the sharding annotations)
  - wide parameter matrices (encoder FFN/attention, joint projections) shard
    over "model" (TP); everything else replicates
  - beams stay chip-local: decode needs no cross-device collectives, matching
    the reference's design where beams never leave a thread pool

Pipeline/expert parallelism are not applicable to this architecture (no
layer-serial pipeline worth cutting at this scale, no MoE); sequence
parallelism is unnecessary because the lattice scan is already only O(B*T)
live state per step.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ssnt_tts.utils.config import MeshConfig


def make_mesh(config: Optional[MeshConfig] = None,
              devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if config is None:
        config = MeshConfig(data=len(devices), model=1)
    need = config.data * config.model
    if need > len(devices):
        raise ValueError(
            f"mesh {config.data}x{config.model} needs {need} devices, "
            f"found {len(devices)}"
        )
    dev_array = np.asarray(devices[:need]).reshape(config.data, config.model)
    return Mesh(dev_array, ("data", "model"))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-major arrays: shard dim 0 over the data axis."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def param_sharding(mesh: Mesh, params):
    """Shard wide parameter matrices over the model axis (TP), replicate the
    rest. Rule: 2-D kernels with out-dim divisible by the model-axis size
    shard on the output dim; embeddings shard on the feature dim."""
    axis = "model"
    size = mesh.shape[axis]

    def spec_for(path, x):
        if x.ndim >= 2 and x.shape[-1] % size == 0 and x.shape[-1] >= size:
            return NamedSharding(mesh, P(*([None] * (x.ndim - 1) + [axis])))
        return NamedSharding(mesh, P())

    flat = jax.tree_util.tree_map_with_path(spec_for, params)
    return flat
