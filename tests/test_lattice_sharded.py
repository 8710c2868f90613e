"""T-axis-sharded lattice loss vs the unsharded reference (SURVEY §5
long-context row; ring frontier exchange via shard_map + ppermute)."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ssnt_tts.ops import lattice, lattice_sharded


def _mesh(n, name="model"):
    devs = np.asarray(jax.devices()[:n])
    return Mesh(devs.reshape(n), (name,))


def _inputs(rng, U, B, T):
    le = jnp.asarray(np.log(rng.uniform(0.1, 0.9, (U, B, T))), jnp.float32)
    ls = jnp.log1p(-jnp.exp(le))
    lf = jnp.asarray(rng.normal(0, 0.5, (U, B, T)), jnp.float32)
    return le, ls, lf


def test_tsharded_matches_reference_ragged():
    rng = np.random.default_rng(0)
    U, B, T = 24, 3, 16  # T sharded 8 ways -> Tl = 2
    le, ls, lf = _inputs(rng, U, B, T)
    il = jnp.asarray([16, 11, 7], jnp.int32)
    ol = jnp.asarray([24, 15, 9], jnp.int32)
    mesh = _mesh(8)
    got = lattice_sharded.ssnt_loss_tsharded(le, ls, lf, il, ol, mesh)
    want = lattice.ssnt_loss(le, ls, lf, il, ol, layout="ubt")
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5
    )


def test_tsharded_blocked_wavefront_all_block_sizes():
    """Round-5 collective restructure (VERDICT r4 #5): the blocked
    wavefront (K columns per ring hop, staggered shards, single post-scan
    psum) must agree with the unsharded reference for every block size,
    including the per-column K=1 path and the K=U single-block case."""
    rng = np.random.default_rng(3)
    U, B, T = 24, 3, 16
    le, ls, lf = _inputs(rng, U, B, T)
    il = jnp.asarray([16, 11, 7], jnp.int32)
    ol = jnp.asarray([24, 15, 9], jnp.int32)
    want = np.asarray(lattice.ssnt_loss(le, ls, lf, il, ol, layout="ubt"))
    for n in (2, 8):
        mesh = _mesh(n)
        for block in (1, 2, 4, 8, 12, 24):
            got = lattice_sharded.ssnt_loss_tsharded(
                le, ls, lf, il, ol, mesh, block=block
            )
            np.testing.assert_allclose(
                np.asarray(got), want, rtol=1e-5, atol=1e-5,
                err_msg=f"n={n} block={block}",
            )


def test_tsharded_blocked_gradients():
    """Autodiff through the staggered wavefront (dynamic_index + inner
    scan + ppermute) matches the unsharded gradient."""
    rng = np.random.default_rng(4)
    U, B, T = 24, 2, 8
    le, ls, lf = _inputs(rng, U, B, T)
    il = jnp.asarray([8, 6], jnp.int32)
    ol = jnp.asarray([24, 17], jnp.int32)
    mesh = _mesh(4)
    g_sh = jax.grad(
        lambda a, b, c: jnp.sum(
            lattice_sharded.ssnt_loss_tsharded(
                a, b, c, il, ol, mesh, block=8
            )
        ),
        argnums=(0, 1, 2),
    )(le, ls, lf)
    g_ref = jax.grad(
        lambda a, b, c: jnp.sum(
            lattice.ssnt_loss(a, b, c, il, ol, layout="ubt")
        ),
        argnums=(0, 1, 2),
    )(le, ls, lf)
    for gs, gr, name in zip(g_sh, g_ref, ["emit", "shift", "frame"]):
        np.testing.assert_allclose(
            np.asarray(gs), np.asarray(gr), rtol=1e-4, atol=1e-5,
            err_msg=name,
        )


def test_tsharded_gradients_match_reference():
    """Autodiff through scan + ppermute = the mirrored-ring beta pass."""
    rng = np.random.default_rng(1)
    U, B, T = 16, 2, 8  # 4-way shard
    le, ls, lf = _inputs(rng, U, B, T)
    il = jnp.asarray([8, 6], jnp.int32)
    ol = jnp.asarray([16, 10], jnp.int32)
    mesh = _mesh(4)

    g_sh = jax.grad(
        lambda a, b, c: jnp.sum(
            lattice_sharded.ssnt_loss_tsharded(a, b, c, il, ol, mesh)
        ),
        argnums=(0, 1, 2),
    )(le, ls, lf)
    g_ref = jax.grad(
        lambda a, b, c: jnp.sum(
            lattice.ssnt_loss(a, b, c, il, ol, layout="ubt")
        ),
        argnums=(0, 1, 2),
    )(le, ls, lf)
    for gs, gr, name in zip(g_sh, g_ref, ["emit", "shift", "frame"]):
        np.testing.assert_allclose(
            np.asarray(gs), np.asarray(gr), rtol=1e-4, atol=1e-5,
            err_msg=name,
        )


def test_tsharded_memory_is_column_not_lattice():
    """The jitted sharded loss must not materialize the (U, B, T) alpha
    lattice: its scan carry is one (B, Tl) column. We can't inspect device
    allocations portably, but we CAN check the loss still runs when the
    lattice is much larger than a single column (smoke at U=128)."""
    rng = np.random.default_rng(2)
    U, B, T = 128, 2, 16
    le, ls, lf = _inputs(rng, U, B, T)
    il = jnp.full((B,), T, jnp.int32)
    ol = jnp.full((B,), U, jnp.int32)
    mesh = _mesh(8)
    out = lattice_sharded.ssnt_loss_tsharded(le, ls, lf, il, ol, mesh)
    want = lattice.ssnt_loss(le, ls, lf, il, ol, layout="ubt")
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(want), rtol=1e-5, atol=1e-5
    )


def test_tsharding_reachable_from_training_config():
    """VERDICT r3 #5b: a training config (ModelConfig.lattice_tshard_min_cells)
    must actually reach the T-sharded loss through the sharded train step.
    With the threshold at 0 every lattice T-shards; the step must run and
    produce the same loss as the unsharded train step."""
    from ssnt_tts.models import SSNTModel
    from ssnt_tts.parallel import mesh as mesh_lib
    from ssnt_tts.parallel import train as train_lib
    from ssnt_tts.utils.config import (
        MeshConfig, TrainConfig, tiny_model_config,
    )

    rng = np.random.default_rng(5)
    B, T, U = 4, 8, 12  # T divisible by the model axis (2)
    batch = {
        "tokens": jnp.asarray(rng.integers(1, 32, (B, T)), jnp.int32),
        "mel": jnp.asarray(rng.normal(0, 1, (B, U, 8)), jnp.float32),
        "input_length": jnp.full((B,), T, jnp.int32),
        "output_length": jnp.full((B,), U, jnp.int32),
    }
    tcfg = TrainConfig(warmup_steps=2, batch_size=B)
    mesh = mesh_lib.make_mesh(
        MeshConfig(data=4, model=2), devices=jax.devices()[:8]
    )

    def one_step(min_cells):
        cfg = tiny_model_config(lattice_tshard_min_cells=min_cells)
        model = SSNTModel(cfg)
        state = train_lib.init_train_state(
            model, jax.random.PRNGKey(0), batch, tcfg
        )
        tx = train_lib.make_optimizer(tcfg)
        step_fn, sharded_state = train_lib.make_sharded_train_step(
            model, tx, mesh, state
        )
        b = jax.device_put(batch, mesh_lib.data_sharding(mesh))
        _, metrics = step_fn(sharded_state, b)
        return float(metrics["loss"])

    loss_tshard = one_step(0)        # every lattice T-shards
    loss_plain = one_step(None)      # never
    assert np.isfinite(loss_tshard)
    np.testing.assert_allclose(loss_tshard, loss_plain, rtol=1e-4)

    # Sanity on the dispatch helper itself.
    from ssnt_tts.ops import lattice_sharded as ls_mod
    assert ls_mod.active_tshard(4, 4, 4) is None  # no context
    with ls_mod.tshard_lattice(mesh, "model", min_cells=10**9):
        assert ls_mod.active_tshard(4, 4, 4) is None  # below threshold
    with ls_mod.tshard_lattice(mesh, "model", min_cells=0):
        assert ls_mod.active_tshard(4, 4, 8) is not None
        assert ls_mod.active_tshard(4, 4, 7) is None  # T % axis != 0
