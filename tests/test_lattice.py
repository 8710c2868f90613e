"""SSNT forward-backward lattice losses.

Checks, per BASELINE.json configs[0]/[1]:
  - loss equals brute-force enumeration over all alignment paths
  - custom_vjp analytic gradients match autodiff-through-scan exactly-ish
    and finite differences
  - ragged batches match per-example computation
"""

import itertools

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ssnt_tts.ops import lattice


def brute_force_v1(log_emit, log_shift, log_frame):
    """Enumerate all monotone paths t_0=0..t_{U-1}=T-1 (steps of 0/1)."""
    T, U = log_emit.shape
    total = -np.inf
    for steps in itertools.product([0, 1], repeat=U - 1):
        ts = np.cumsum((0,) + steps)
        if ts[-1] != T - 1:
            continue
        lp = log_frame[0, 0]
        for u in range(1, U):
            prev_t = ts[u - 1]
            lp += (
                log_shift[prev_t, u - 1]
                if steps[u - 1]
                else log_emit[prev_t, u - 1]
            )
            lp += log_frame[ts[u], u]
        lp += log_emit[T - 1, U - 1]  # final stop emit
        total = np.logaddexp(total, lp)
    return -total


def rand_inputs(rng, B, T, U):
    le = np.log(rng.uniform(0.1, 0.9, (B, T, U))).astype(np.float32)
    ls = np.log1p(-np.exp(le)).astype(np.float32)  # emit+shift normalized
    lf = rng.normal(0, 0.5, (B, T, U)).astype(np.float32)
    return le, ls, lf


@pytest.mark.parametrize("T,U", [(1, 1), (2, 3), (3, 5), (4, 4)])
def test_loss_matches_brute_force(T, U):
    rng = np.random.default_rng(T * 10 + U)
    le, ls, lf = rand_inputs(rng, 2, T, U)
    got = jax.jit(lattice.ssnt_loss)(le, ls, lf)
    for b in range(2):
        want = brute_force_v1(le[b], ls[b], lf[b])
        # XLA's f32 exp/log1p are ~1e-4-accurate approximations, so exact
        # f32 ULP agreement with numpy is not achievable.
        np.testing.assert_allclose(np.asarray(got)[b], want, rtol=5e-4,
                                   atol=1e-4)


def test_impossible_path_is_inf_like():
    """U < T means no monotone path reaches t=T-1 (shift also emits)."""
    rng = np.random.default_rng(0)
    le, ls, lf = rand_inputs(rng, 1, 5, 3)
    got = np.asarray(jax.jit(lattice.ssnt_loss)(le, ls, lf))
    assert got[0] > 1e20  # NEG-saturated, not NaN
    assert np.isfinite(got[0]) or got[0] > 0


def test_custom_vjp_matches_autodiff():
    rng = np.random.default_rng(1)
    B, T, U = 3, 4, 7
    le, ls, lf = rand_inputs(rng, B, T, U)

    def total_custom(le, ls, lf):
        return jnp.sum(lattice.ssnt_loss(le, ls, lf))

    def total_ref(le, ls, lf):
        return jnp.sum(lattice.ssnt_loss_reference(le, ls, lf))

    g_custom = jax.jit(jax.grad(total_custom, argnums=(0, 1, 2)))(le, ls, lf)
    g_ref = jax.jit(jax.grad(total_ref, argnums=(0, 1, 2)))(le, ls, lf)
    for gc, gr, name in zip(g_custom, g_ref, ["emit", "shift", "frame"]):
        np.testing.assert_allclose(
            np.asarray(gc), np.asarray(gr), rtol=2e-4, atol=1e-6,
            err_msg=name,
        )


def test_grad_finite_differences():
    rng = np.random.default_rng(2)
    B, T, U = 1, 3, 5
    le, ls, lf = rand_inputs(rng, B, T, U)
    f = jax.jit(lambda a, b, c: jnp.sum(lattice.ssnt_loss(a, b, c)))
    grads = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(le, ls, lf)
    eps = 1e-3
    for argi, arr in enumerate([le, ls, lf]):
        for (t, u) in [(0, 0), (1, 2), (2, 4), (T - 1, U - 1)]:
            d = np.zeros_like(arr)
            d[0, t, u] = eps
            args_p = [le, ls, lf]
            args_m = [le, ls, lf]
            args_p[argi] = arr + d
            args_m[argi] = arr - d
            fd = (float(f(*args_p)) - float(f(*args_m))) / (2 * eps)
            an = float(np.asarray(grads[argi])[0, t, u])
            np.testing.assert_allclose(an, fd, rtol=5e-2, atol=5e-3,
                                       err_msg=f"arg{argi} ({t},{u})")


def test_variable_lengths_match_unpadded():
    rng = np.random.default_rng(3)
    B, T, U = 3, 5, 9
    le, ls, lf = rand_inputs(rng, B, T, U)
    T_b = np.array([5, 3, 4], np.int32)
    U_b = np.array([9, 6, 7], np.int32)
    got = np.asarray(
        jax.jit(lattice.ssnt_loss)(le, ls, lf, T_b, U_b)
    )
    for b in range(B):
        want = np.asarray(
            lattice.ssnt_loss(
                le[b : b + 1, : T_b[b], : U_b[b]],
                ls[b : b + 1, : T_b[b], : U_b[b]],
                lf[b : b + 1, : T_b[b], : U_b[b]],
            )
        )[0]
        np.testing.assert_allclose(got[b], want, rtol=1e-5, atol=1e-5)


def test_variable_length_grads_zero_outside():
    rng = np.random.default_rng(4)
    B, T, U = 2, 5, 8
    le, ls, lf = rand_inputs(rng, B, T, U)
    T_b = np.array([4, 5], np.int32)
    U_b = np.array([6, 8], np.int32)
    f = lambda a, b, c: jnp.sum(lattice.ssnt_loss(a, b, c, T_b, U_b))
    g_le, g_ls, g_lf = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(le, ls, lf)
    for g in (g_le, g_ls, g_lf):
        g = np.asarray(g)
        assert np.all(g[0, 4:, :] == 0)
        assert np.all(g[0, :, 6:] == 0)
        assert np.isfinite(g).all()


def test_occupancy_posteriors_are_marginals():
    """-d(loss)/d(log_frame[:, :, u]) sums to 1 over t for every valid frame
    u (the occupancy posterior is a probability distribution over source
    positions) — a strong structural check on the custom_vjp."""
    rng = np.random.default_rng(11)
    B, T, U = 3, 5, 12
    le, ls, lf = rand_inputs(rng, B, T, U)
    T_b = np.array([5, 4, 3], np.int32)
    U_b = np.array([12, 8, 6], np.int32)
    g_lf = jax.jit(
        jax.grad(
            lambda c: jnp.sum(lattice.ssnt_loss(le, ls, c, T_b, U_b)),
        )
    )(lf)
    g_lf = np.asarray(g_lf)
    for b in range(B):
        occ = -g_lf[b, :, : U_b[b]].sum(axis=0)  # sum over t per frame
        np.testing.assert_allclose(occ, 1.0, rtol=5e-4)


# ------------------------------------------------------------- duration (v2)

def brute_force_duration(log_h, durations, T, U):
    D = log_h.shape[1]
    total = -np.inf
    for seq in itertools.product(range(D), repeat=T):
        if sum(durations[d] for d in seq) != U:
            continue
        lp = sum(log_h[t, d] for t, d in enumerate(seq))
        total = np.logaddexp(total, lp)
    return -total


@pytest.mark.parametrize("T,U", [(2, 4), (3, 6), (4, 5)])
def test_duration_loss_matches_brute_force(T, U):
    rng = np.random.default_rng(T + U)
    D = 4
    durations = (0, 1, 2, 3)
    log_h = jax.nn.log_softmax(
        jnp.asarray(rng.normal(0, 1, (1, T, D)), jnp.float32), axis=-1
    )
    got = float(
        jax.jit(
            lattice.ssnt_duration_loss, static_argnames=("duration_table",)
        )(log_h, duration_table=durations,
          output_length=jnp.asarray([U], jnp.int32))[0]
    )
    want = brute_force_duration(np.asarray(log_h)[0], durations, T, U)
    # XLA f32 exp/log are ~1e-4-accurate approximations.
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-4)


def test_duration_loss_grad_finite_diff():
    rng = np.random.default_rng(9)
    T, D, U = 3, 3, 4
    durations = (0, 1, 2)
    x = rng.normal(0, 1, (1, T, D)).astype(np.float32)

    def f(x):
        lh = jax.nn.log_softmax(x, axis=-1)
        return jnp.sum(
            lattice.ssnt_duration_loss(
                lh, duration_table=durations,
                output_length=jnp.asarray([U], jnp.int32),
            )
        )

    g = np.asarray(jax.jit(jax.grad(f))(x))
    eps = 1e-3
    for t in range(T):
        for d in range(D):
            dx = np.zeros_like(x)
            dx[0, t, d] = eps
            fd = (float(f(x + dx)) - float(f(x - dx))) / (2 * eps)
            np.testing.assert_allclose(g[0, t, d], fd, rtol=5e-2, atol=5e-3)
