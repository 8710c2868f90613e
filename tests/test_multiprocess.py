"""Multi-PROCESS jax.distributed training test (SURVEY §4, VERDICT r2 #3).

Spawns 2 real OS processes, each owning 2 virtual CPU devices, wired by a
localhost coordinator through the production path (multihost.initialize ->
global_data_mesh -> host_local_batch_to_global -> make_sharded_train_step),
and asserts:
  - the cluster actually formed (process_count == 2, 4 global devices);
  - both processes agree on losses and final parameters (the gradient psum
    crossed the process boundary);
  - the 2-process run reproduces a single-process run on the same global
    batch (data-parallel partitioning is value-correct).

Runs its workers in subprocesses because jax.distributed can only be
initialized once per process; skips (with reason) if the rig forbids
subprocesses or lacks CPU cross-process collectives.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "mp_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_cluster(num_procs, tmp_path, per_host_batch=4, timeout=600):
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env.pop("JAX_NUM_CPU_DEVICES", None)
    procs, outs = [], []
    for pid in range(num_procs):
        out = tmp_path / f"worker_{pid}.json"
        outs.append(out)
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, _WORKER,
                    "--coordinator", f"localhost:{port}",
                    "--num-processes", str(num_procs),
                    "--process-id", str(pid),
                    "--out", str(out),
                    "--per-host-batch", str(per_host_batch),
                ],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout)
    return procs, outs, logs


def test_two_process_training_matches_single_process(tmp_path):
    try:
        procs, outs, logs = _run_cluster(2, tmp_path)
    except (OSError, subprocess.TimeoutExpired) as e:  # pragma: no cover
        pytest.skip(f"cannot run subprocess cluster on this rig: {e!r}")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"

    results = [json.loads(o.read_text()) for o in outs]
    for r in results:
        assert r["process_count"] == 2
        assert r["global_devices"] == 4
        assert r["local_devices"] == 2
    assert results[0]["is_primary"] and not results[1]["is_primary"]

    # Cross-process agreement: psum'd losses and replicated params.
    np.testing.assert_allclose(
        results[0]["losses"], results[1]["losses"], rtol=1e-6
    )
    np.testing.assert_allclose(
        results[0]["param_checksum"], results[1]["param_checksum"],
        rtol=1e-6,
    )

    # Single-process ground truth on the same global batch (this test
    # process already has 8 virtual devices from conftest; the worker's
    # deterministic batch construction is replicated here).
    import jax

    from ssnt_tts.models import SSNTModel
    from ssnt_tts.parallel import multihost
    from ssnt_tts.parallel import train as train_lib
    from ssnt_tts.utils.config import TrainConfig, tiny_model_config

    cfg = tiny_model_config()
    model = SSNTModel(cfg)
    B, T, U = 8, 12, 30
    rng = np.random.default_rng(0)
    batch = {
        "tokens": rng.integers(1, cfg.vocab_size, (B, T)).astype(np.int32),
        "mel": rng.normal(0, 1, (B, U, cfg.mel_dim)).astype(np.float32),
        "input_length": np.full((B,), T, np.int32),
        "output_length": np.full((B,), U, np.int32),
    }
    mesh = multihost.global_data_mesh(model_axis=1)  # 8 local devices
    gbatch = multihost.host_local_batch_to_global(batch, mesh)
    tcfg = TrainConfig(warmup_steps=2, batch_size=B)
    state = train_lib.init_train_state(
        model, jax.random.PRNGKey(0), gbatch, tcfg
    )
    tx = train_lib.make_optimizer(tcfg)
    step_fn, state = train_lib.make_sharded_train_step(
        model, tx, mesh, state
    )
    losses = []
    for _ in range(2):
        state, metrics = step_fn(state, gbatch)
        losses.append(float(np.asarray(metrics["loss"])))

    np.testing.assert_allclose(results[0]["losses"], losses, rtol=2e-5)


def test_initialize_raises_when_cluster_env_is_broken(monkeypatch):
    """A detected-but-broken cluster must raise, not silently fall back to
    single-process training on 1/N hosts (VERDICT r2 missing #1)."""
    import jax

    from ssnt_tts.parallel import multihost

    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1")

    def boom(*a, **k):
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    with pytest.raises(RuntimeError, match="refusing to fall back"):
        multihost.initialize()
