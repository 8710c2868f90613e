"""Blocked-parallel-scan lattice vs the sequential XLA reference."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ssnt_tts.ops import lattice, lattice_scan


def rand_inputs(rng, B, T, U):
    le = np.log(rng.uniform(0.1, 0.9, (B, T, U))).astype(np.float32)
    ls = np.log1p(-np.exp(le)).astype(np.float32)
    lf = rng.normal(0, 0.5, (B, T, U)).astype(np.float32)
    return le, ls, lf


@pytest.mark.parametrize("K", [2, 4, 8])
@pytest.mark.parametrize("U", [7, 16, 33])
def test_loss_matches_sequential(K, U):
    rng = np.random.default_rng(K * 100 + U)
    B, T = 3, 6
    le, ls, lf = rand_inputs(rng, B, T, U)
    got = np.asarray(
        jax.jit(
            lambda a, b, c: lattice_scan.ssnt_loss_scan(a, b, c, K=K)
        )(le, ls, lf)
    )
    want = np.asarray(jax.jit(lattice.ssnt_loss)(le, ls, lf))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_ragged_lengths_match():
    rng = np.random.default_rng(0)
    B, T, U = 4, 7, 25
    le, ls, lf = rand_inputs(rng, B, T, U)
    T_b = np.array([7, 5, 6, 4], np.int32)
    U_b = np.array([25, 12, 18, 9], np.int32)
    got = np.asarray(
        jax.jit(
            lambda a, b, c: lattice_scan.ssnt_loss_scan(
                a, b, c, T_b, U_b, K=4
            )
        )(le, ls, lf)
    )
    want = np.asarray(jax.jit(lattice.ssnt_loss)(le, ls, lf, T_b, U_b))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_grads_match_sequential():
    rng = np.random.default_rng(1)
    B, T, U = 3, 5, 17
    le, ls, lf = rand_inputs(rng, B, T, U)
    T_b = np.array([5, 4, 3], np.int32)
    U_b = np.array([17, 10, 7], np.int32)
    g_scan = jax.jit(
        jax.grad(
            lambda a, b, c: jnp.sum(
                lattice_scan.ssnt_loss_scan(a, b, c, T_b, U_b, K=4)
            ),
            argnums=(0, 1, 2),
        )
    )(le, ls, lf)
    g_seq = jax.jit(
        jax.grad(
            lambda a, b, c: jnp.sum(lattice.ssnt_loss(a, b, c, T_b, U_b)),
            argnums=(0, 1, 2),
        )
    )(le, ls, lf)
    for gs, gq, name in zip(g_scan, g_seq, ["emit", "shift", "frame"]):
        np.testing.assert_allclose(
            np.asarray(gs), np.asarray(gq), rtol=2e-3, atol=2e-5,
            err_msg=name,
        )


def test_alphas_betas_directly():
    rng = np.random.default_rng(2)
    B, T, U = 2, 5, 16
    le, ls, lf = rand_inputs(rng, B, T, U)
    lev = jnp.transpose(jnp.asarray(le), (2, 0, 1))
    lsv = jnp.transpose(jnp.asarray(ls), (2, 0, 1))
    lfv = jnp.transpose(jnp.asarray(lf), (2, 0, 1))
    a_scan = np.asarray(
        jax.jit(
            lambda a, b, c: lattice_scan.forward_alphas_scan(a, b, c, K=4)
        )(lev, lsv, lfv)
    )
    a_seq = np.asarray(lattice._forward_alphas(lev, lsv, lfv))
    valid = a_seq > lattice.NEG / 2
    np.testing.assert_allclose(
        a_scan[valid], a_seq[valid], rtol=1e-4, atol=1e-4
    )

    T_b = jnp.full((B,), T, jnp.int32)
    U_b = jnp.full((B,), U, jnp.int32)
    b_scan = np.asarray(
        jax.jit(
            lambda a, b, c: lattice_scan.backward_betas_scan(
                a, b, c, T_b, K=4
            )
        )(lev, lsv, lfv)
    )
    b_seq = np.asarray(
        lattice._backward_betas(lev, lsv, lfv, T_b, U_b)
    )
    validb = b_seq > lattice.NEG / 2
    np.testing.assert_allclose(
        b_scan[validb], b_seq[validb], rtol=1e-4, atol=1e-4
    )
