"""v2 duration-class beam step: constraint semantics + oracle conformance.

Reference: /root/reference/src/v2.rs (untested there — SURVEY.md §4); the
oracle is an independent articulation of its semantics, and these tests pin
the JAX op to it bit-exactly, including the diagonal band/overrun/exact-final
-length prunes and the diagonal re-injection fallback.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ssnt_tts.ops import beam_v2
from ssnt_tts.oracle import numpy_oracle as oracle

_NAMES = ["prediction", "log_prob", "next_t", "next_u", "is_finished",
          "total_duration", "beam_branch"]

_step = jax.jit(
    beam_v2.beam_search_step,
    static_argnames=(
        "zero_duration_id", "allow_skip", "test_mode", "max_beam_width",
        "return_num_survivors",
    ),
)


def run_jax(h, lph, fin, tot, dur_table, t, u, T, U, **kw):
    outs = _step(
        jnp.asarray(h, jnp.float32),
        jnp.asarray(lph, jnp.float32),
        jnp.asarray(fin),
        jnp.asarray(tot, jnp.int32),
        jnp.asarray(dur_table, jnp.int32),
        jnp.asarray(t, jnp.int32),
        jnp.asarray(u, jnp.int32),
        T,
        U,
        **kw,
    )
    return {k: np.asarray(v) for k, v in zip(_NAMES, outs)}


def assert_matches_oracle(h, lph, fin, tot, dur_table, t, u, T, U, *,
                          zero_duration_id, allow_skip, test_mode,
                          max_beam_width=None):
    W = h.shape[0]
    max_w = max_beam_width or W
    got = run_jax(h, lph, fin, tot, dur_table, t, u, T, U,
                  zero_duration_id=zero_duration_id, allow_skip=allow_skip,
                  test_mode=test_mode, max_beam_width=max_beam_width)
    want = oracle.candidates_to_arrays(
        oracle.v2_beam_search_kernel(
            h, lph, fin, tot, dur_table, t, u, T, U,
            zero_duration_id, allow_skip, test_mode, max_w,
        ),
        with_duration=True,
    )
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_test_mode_all_classes():
    """test_mode disables every duration constraint (src/v2.rs:131-137);
    the reference wrapper zeroes output_length (__init__.py:47)."""
    W, D, T = 2, 4, 10
    rng = np.random.default_rng(0)
    h = np.log(rng.uniform(0.05, 1.0, (W, D))).astype(np.float32)
    lph = np.zeros(W, np.float32)
    fin = np.zeros(W, bool)
    tot = np.zeros(W, np.int32)
    dur = np.array([0, 1, 2, 3], np.int32)
    t = np.zeros(W, np.int32)
    u = np.zeros(W, np.int32)
    assert_matches_oracle(h, lph, fin, tot, dur, t, u, T, 0,
                          zero_duration_id=0, allow_skip=False,
                          test_mode=True)


def test_zero_duration_pruning():
    W, D, T = 2, 3, 10
    rng = np.random.default_rng(1)
    h = np.log(rng.uniform(0.05, 1.0, (W, D))).astype(np.float32)
    lph = np.zeros(W, np.float32)
    fin = np.zeros(W, bool)
    tot = np.zeros(W, np.int32)
    dur = np.array([0, 2, 4], np.int32)
    t = np.zeros(W, np.int32)
    u = np.zeros(W, np.int32)
    for allow_skip in (False, True):
        assert_matches_oracle(h, lph, fin, tot, dur, t, u, T, 0,
                              zero_duration_id=0, allow_skip=allow_skip,
                              test_mode=True)


def test_diagonal_band_and_final_length():
    """Realistic mid-decode state exercising the band prune, the exact
    final-length constraint, and the diagonal re-injection."""
    W, D = 4, 6
    T, U = 10, 40
    rng = np.random.default_rng(2)
    h = np.log(rng.uniform(0.05, 1.0, (W, D))).astype(np.float32)
    dur = np.array([0, 2, 3, 4, 5, 6], np.int32)
    for tpos in range(T):
        lph = -rng.uniform(0, 2, W).astype(np.float32)
        fin = np.zeros(W, bool)
        # Totals near the diagonal so some classes stay in band.
        diag = int(U / T * (tpos + 1))
        tot = np.clip(diag - 4 + rng.integers(0, 8, W), 0, U).astype(np.int32)
        t = np.full(W, tpos, np.int32)
        u = np.full(W, tpos, np.int32)
        assert_matches_oracle(h, lph, fin, tot, dur, t, u, T, U,
                              zero_duration_id=0, allow_skip=False,
                              test_mode=False)


def test_finished_padding_and_mixed_state():
    W, D = 3, 4
    T, U = 8, 30
    rng = np.random.default_rng(3)
    h = np.log(rng.uniform(0.05, 1.0, (W, D))).astype(np.float32)
    dur = np.array([0, 3, 4, 5], np.int32)
    lph = -rng.uniform(0, 2, W).astype(np.float32)
    fin = np.array([True, False, False])
    tot = np.array([12, 11, 13], np.int32)
    t = np.array([3, 3, 9], np.int32)  # beam 2 out of range
    u = np.array([3, 3, 3], np.int32)
    assert_matches_oracle(h, lph, fin, tot, dur, t, u, T, U,
                          zero_duration_id=0, allow_skip=False,
                          test_mode=False)


@pytest.mark.parametrize("seed", range(10))
def test_randomized_conformance(seed):
    rng = np.random.default_rng(100 + seed)
    W = int(rng.integers(1, 7))
    D = int(rng.integers(2, 7))
    T = int(rng.integers(2, 12))
    U = int(rng.integers(T, 5 * T))
    test_mode = bool(rng.integers(0, 2))
    allow_skip = bool(rng.integers(0, 2))
    if test_mode:
        U = 0  # reference wrapper zeroes output_length in test_mode
    h = np.log(rng.uniform(0.05, 1.0, (W, D))).astype(np.float32)
    dur = np.sort(rng.integers(0, 6, D)).astype(np.int32)
    lph = rng.choice(np.array([-0.5, -1.0, -1.5], np.float32), W)
    fin = rng.uniform(size=W) < 0.15
    t = rng.integers(0, T + 1, W).astype(np.int32)
    u = rng.integers(0, 8, W).astype(np.int32)
    if test_mode:
        tot = rng.integers(0, 10, W).astype(np.int32)
    else:
        diag = (U / T * (t + 1)).astype(np.int32)
        tot = np.clip(diag + rng.integers(-4, 5, W), 0, max(U, 1)).astype(
            np.int32
        )
    try:
        want = oracle.v2_beam_search_kernel(
            h, lph, fin, tot, dur, t, u, T, U, 0, allow_skip, test_mode, W
        )
    except AssertionError:
        # Reference would panic on an empty beam; the JAX op must report 0
        # survivors instead.
        outs = _step(
            jnp.asarray(h), jnp.asarray(lph), jnp.asarray(fin),
            jnp.asarray(tot), jnp.asarray(dur), jnp.asarray(t),
            jnp.asarray(u), T, U,
            zero_duration_id=0, allow_skip=allow_skip, test_mode=test_mode,
            return_num_survivors=True,
        )
        assert int(outs[-1]) == 0
        return
    got = run_jax(h, lph, fin, tot, dur, t, u, T, U,
                  zero_duration_id=0, allow_skip=allow_skip,
                  test_mode=test_mode)
    wanted = oracle.candidates_to_arrays(want, with_duration=True)
    for k in wanted:
        np.testing.assert_array_equal(got[k], wanted[k], err_msg=k)


def test_batched_wrapper():
    B, W, D = 4, 3, 4
    rng = np.random.default_rng(7)
    T = np.array([6, 8, 10, 7], np.int32)
    U = np.array([20, 30, 35, 25], np.int32)
    h = np.log(rng.uniform(0.05, 1.0, (B, W, D))).astype(np.float32)
    dur = np.array([0, 3, 4, 5], np.int32)
    lph = np.zeros((B, W), np.float32)
    fin = np.zeros((B, W), bool)
    t = np.zeros((B, W), np.int32)
    u = np.zeros((B, W), np.int32)
    tot = np.zeros((B, W), np.int32)
    outs = jax.jit(
        beam_v2.beam_search_decode,
        static_argnames=("zero_duration_id", "allow_skip", "test_mode"),
    )(
        jnp.asarray(h), jnp.asarray(lph), jnp.asarray(fin), jnp.asarray(tot),
        jnp.asarray(dur), jnp.asarray(t), jnp.asarray(u), jnp.asarray(T),
        jnp.asarray(U),
        zero_duration_id=0, allow_skip=False, test_mode=False,
    )
    for b in range(B):
        want = oracle.candidates_to_arrays(
            oracle.v2_beam_search_kernel(
                h[b], lph[b], fin[b], tot[b], dur, t[b], u[b], int(T[b]),
                int(U[b]), 0, False, False, W,
            ),
            with_duration=True,
        )
        for k, got in zip(_NAMES, outs):
            np.testing.assert_array_equal(np.asarray(got)[b], want[k],
                                          err_msg=f"b={b} {k}")


def test_config_round_trip():
    """V2BeamConfig knobs actually reach the kernel (VERDICT r1 #3):
    defaults reproduce the no-config result bit-exactly, and widening the
    band / relaxing the overrun multiplier admits candidates the reference
    constants prune (src/v2.rs:96-116 promoted to config fields)."""
    from ssnt_tts.utils.config import V2BeamConfig

    W, D = 3, 5
    T, U = 10, 40
    rng = np.random.default_rng(7)
    h = np.log(rng.uniform(0.05, 1.0, (W, D))).astype(np.float32)
    dur = np.array([0, 1, 4, 8, 12], np.int32)
    lph = -rng.uniform(0, 2, W).astype(np.float32)
    fin = np.zeros(W, bool)
    tpos = 4
    diag = int(U / T * (tpos + 1))
    tot = np.clip(diag - 3 + rng.integers(0, 6, W), 0, U).astype(np.int32)
    t = np.full(W, tpos, np.int32)
    u = np.full(W, tpos, np.int32)

    args = (
        jnp.asarray(h), jnp.asarray(lph), jnp.asarray(fin),
        jnp.asarray(tot), jnp.asarray(dur), jnp.asarray(t),
        jnp.asarray(u), T, U,
    )
    kw = dict(zero_duration_id=0, allow_skip=False, test_mode=False,
              return_num_survivors=True)
    base = beam_v2.beam_search_step(*args, **kw)
    explicit_default = beam_v2.beam_search_step(
        *args, **kw, config=V2BeamConfig()
    )
    for a, b in zip(base, explicit_default):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # A band wide enough to admit every total (and no overrun prune) must
    # admit at least as many candidates as the reference constants.
    wide = V2BeamConfig(band_lower_frac=10.0, band_upper_frac=10.0,
                        overrun_multiplier=0)
    relaxed = beam_v2.beam_search_step(*args, **kw, config=wide)
    assert int(relaxed[-1]) >= int(base[-1])
    # The reference band genuinely prunes something in this scenario, so the
    # relaxed config must differ — proving the constants are no longer
    # hard-coded in the kernel.
    assert int(relaxed[-1]) > int(base[-1])


def test_final_feasible_guard_prunes_doomed_candidates():
    """Round-5 empty-beam remedy: with the guard on, a candidate whose
    remaining positions cannot reach output_length exactly is pruned
    NOW (not at t=T-1); feasible candidates are untouched."""
    import jax.numpy as jnp
    import numpy as np
    from ssnt_tts.ops import beam_v2
    from ssnt_tts.utils.config import V2BeamConfig

    # T=4, U=8, table [0,1,2,3], no skip -> dmin=1, dmax=3. At t=1 a
    # candidate has f = 2 future positions: needs 2 <= U - tot <= 6.
    dtab = jnp.asarray([0, 1, 2, 3], jnp.int32)
    h = jnp.asarray([[[-1.0, -0.5, -0.5, -0.5],
                      [-1.0, -0.5, -0.5, -0.5]]], jnp.float32)
    hist = jnp.asarray([[0.0, 0.0]], jnp.float32)
    fin = jnp.zeros((1, 2), bool)
    # w0 tot0=3: cands tot 4,5,6; rem 4,3,2 all feasible (>=2).
    # w1 tot0=5: cands tot 6,7,8; rem 2,1,0 -> d2 (rem 1) and d3
    # (rem 0) are DOOMED (rem < f*dmin = 2); d1 (rem 2) feasible.
    tot = jnp.asarray([[3, 5]], jnp.int32)
    t = jnp.asarray([[1, 1]], jnp.int32)
    u = jnp.asarray([[1, 1]], jnp.int32)
    il = jnp.asarray([4], jnp.int32)
    ol = jnp.asarray([8], jnp.int32)

    # Band at t=1: diag = 4.0 -> [3, 4]; so band alone keeps
    # w0 {d1 tot4}, w1 {}(tot 6,7,8 all > 4)... widen the band to
    # isolate the guard's effect.
    wide = V2BeamConfig(band_lower_frac=1.0, band_upper_frac=1.0)
    guard = V2BeamConfig(band_lower_frac=1.0, band_upper_frac=1.0,
                         final_feasible_guard=True)
    kw = dict(zero_duration_id=0, allow_skip=False, test_mode=False)
    pred_w, lp_w, *_ = beam_v2.beam_search_decode(
        h, hist, fin, tot, dtab, t, u, il, ol, config=wide, **kw
    )
    pred_g, lp_g, nt_g, nu_g, fin_g, tot_g, br_g = (
        beam_v2.beam_search_decode(
            h, hist, fin, tot, dtab, t, u, il, ol, config=guard, **kw
        )
    )
    # Without guard: w1 d2/d3 (doomed) compete; with guard they are
    # gone — surviving set {w0d1..d3, w1d1}, all lp -0.5, stable order
    # w0d1 first. w0d1 (tot 4, next_t 2, diag 4.0, diff 0) is also the
    # first on-diagonal candidate, so it is re-injected into the last
    # slot (src/v2.rs:282-308): both slots hold w0d1.
    np.testing.assert_array_equal(np.asarray(pred_g), [[1, 1]])
    np.testing.assert_array_equal(np.asarray(br_g), [[0, 0]])
    # Feasible candidates keep identical fields vs the unguarded run
    # (the guard only removes, never rescores).
    assert float(lp_g[0, 0]) == float(lp_w[0, 0]) == -0.5
