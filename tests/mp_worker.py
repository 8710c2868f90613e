"""Worker for the multi-process jax.distributed test (not pytest-collected).

Each process owns 2 virtual CPU devices; the global mesh spans
num_processes * 2 devices. Runs 2 deterministic train steps through the
exact production path (multihost.initialize -> global_data_mesh ->
host_local_batch_to_global -> make_sharded_train_step) and writes the step
losses + a parameter checksum to --out as JSON.

Launched by tests/test_multiprocess.py; also runnable by hand:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=2 \
  python tests/mp_worker.py --coordinator localhost:9876 --num-processes 2 \
      --process-id 0 --out /tmp/w0.json
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--per-host-batch", type=int, default=4)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    # jax.distributed.initialize must run before anything touches the XLA
    # backend, so the framework imports come AFTER the cluster is wired.
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    import numpy as np

    from ssnt_tts.parallel import multihost
    from ssnt_tts.parallel import train as train_lib
    from ssnt_tts.models import SSNTModel
    from ssnt_tts.utils.config import TrainConfig, tiny_model_config

    assert jax.process_count() == args.num_processes

    mesh = multihost.global_data_mesh(model_axis=1)

    cfg = tiny_model_config()
    model = SSNTModel(cfg)
    B_global = args.per_host_batch * args.num_processes
    T, U = 12, 30
    rng = np.random.default_rng(0)  # same global batch on every process
    global_batch = {
        "tokens": rng.integers(1, cfg.vocab_size, (B_global, T)).astype(
            np.int32
        ),
        "mel": rng.normal(0, 1, (B_global, U, cfg.mel_dim)).astype(
            np.float32
        ),
        "input_length": np.full((B_global,), T, np.int32),
        "output_length": np.full((B_global,), U, np.int32),
    }
    lo = args.process_id * args.per_host_batch
    hi = lo + args.per_host_batch
    local = {k: v[lo:hi] for k, v in global_batch.items()}
    gbatch = multihost.host_local_batch_to_global(local, mesh)

    tcfg = TrainConfig(warmup_steps=2, batch_size=B_global)
    state = train_lib.init_train_state(
        model, jax.random.PRNGKey(0), gbatch, tcfg
    )
    tx = train_lib.make_optimizer(tcfg)
    step_fn, state = train_lib.make_sharded_train_step(model, tx, mesh, state)

    losses = []
    for _ in range(2):
        state, metrics = step_fn(state, gbatch)
        losses.append(float(np.asarray(metrics["loss"])))

    # Parameter checksum: identical on every process (grad psum is global).
    leaves = jax.tree.leaves(jax.device_get(state.params))
    checksum = float(sum(np.abs(x).sum() for x in leaves))

    with open(args.out, "w") as f:
        json.dump(
            {
                "process_id": args.process_id,
                "process_count": jax.process_count(),
                "global_devices": jax.device_count(),
                "local_devices": jax.local_device_count(),
                "losses": losses,
                "param_checksum": checksum,
                "is_primary": multihost.is_primary(),
            },
            f,
        )


if __name__ == "__main__":
    main()
