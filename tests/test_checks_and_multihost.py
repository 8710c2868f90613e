"""checkify failure-semantics wrappers + single-process multihost helpers."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp


def test_v2_checked_flags_empty_beam():
    from ssnt_tts.ops import checks

    W, D = 2, 2
    h = np.log(np.full((W, D), 0.5, np.float32))
    # Impossible: at t=T-1 the total must equal U exactly but no class fits.
    err, outs = checks.v2_beam_search_step_checked(
        jnp.asarray(h),
        jnp.zeros(W, jnp.float32),
        jnp.zeros(W, bool),
        jnp.zeros(W, jnp.int32),
        jnp.asarray([1, 2], jnp.int32),
        jnp.full((W,), 0, jnp.int32),  # t = 0 = T-1
        jnp.zeros(W, jnp.int32),
        1,  # T
        100,  # U (unreachable)
        zero_duration_id=0,
        allow_skip=False,
        test_mode=False,
    )
    with pytest.raises(Exception):
        err.throw()


def test_v2_checked_passes_valid():
    from ssnt_tts.ops import checks

    W, D = 2, 3
    h = np.log(np.full((W, D), 0.3, np.float32))
    err, outs = checks.v2_beam_search_step_checked(
        jnp.asarray(h),
        jnp.zeros(W, jnp.float32),
        jnp.zeros(W, bool),
        jnp.zeros(W, jnp.int32),
        jnp.asarray([0, 1, 2], jnp.int32),
        jnp.zeros(W, jnp.int32),
        jnp.zeros(W, jnp.int32),
        5,
        0,
        zero_duration_id=0,
        allow_skip=False,
        test_mode=True,
    )
    err.throw()  # no error
    assert np.asarray(outs[0]).shape == (W,)


def test_upsample_checked():
    from ssnt_tts.ops import checks

    dur = jnp.asarray(np.array([[[2, 1]]], np.int32))
    ok_len = jnp.asarray(np.array([[3]], np.int32))
    bad_len = jnp.asarray(np.array([[4]], np.int32))
    err, out = checks.upsample_source_indexes_checked(dur, ok_len, -1, max_u=4)
    err.throw()
    np.testing.assert_array_equal(np.asarray(out)[0, 0], [0, 0, 1, -1])
    err, _ = checks.upsample_source_indexes_checked(dur, bad_len, -1, max_u=4)
    with pytest.raises(Exception):
        err.throw()


def test_multihost_single_process_path():
    from ssnt_tts.parallel import multihost

    assert multihost.process_count() == 1
    assert multihost.is_primary()
    mesh = multihost.global_data_mesh(model_axis=2)
    assert mesh.shape["data"] * mesh.shape["model"] == len(jax.devices())
    batch = {"x": np.arange(16, dtype=np.float32).reshape(8, 2)}
    g = multihost.host_local_batch_to_global(batch, mesh)
    np.testing.assert_array_equal(np.asarray(g["x"]), batch["x"])
