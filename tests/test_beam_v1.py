"""v1 emit/shift beam step: golden vectors + randomized oracle conformance.

Golden anchor: /root/reference/tests/test_decoding.rs:14-51 drives the Rust
kernel for two steps on uniform [0.8, 0.2] probability rows; the expected
values below were derived by executing the reference semantics (oracle) and
match the printed output of the Rust test.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ssnt_tts.ops import beam_v1
from ssnt_tts.oracle import numpy_oracle as oracle

_step = jax.jit(beam_v1.beam_search_step, static_argnames=("max_beam_width",))
_batched = jax.jit(
    beam_v1.beam_search_decode_batched, static_argnames=("max_beam_width",)
)


def run_jax(h, lph, fin, t, u, T, max_beam_width=None):
    outs = _step(
        jnp.asarray(h, jnp.float32),
        jnp.asarray(lph, jnp.float32),
        jnp.asarray(fin),
        jnp.asarray(t, jnp.int32),
        jnp.asarray(u, jnp.int32),
        T,
        max_beam_width=max_beam_width,
    )
    names = ["prediction", "log_prob", "next_t", "next_u", "is_finished",
             "beam_branch"]
    return {k: np.asarray(v) for k, v in zip(names, outs)}


def assert_matches_oracle(h, lph, fin, t, u, T, max_beam_width):
    got = run_jax(h, lph, fin, t, u, T, max_beam_width)
    want = oracle.candidates_to_arrays(
        oracle.v1_beam_search_kernel(h, lph, fin, t, u, T, max_beam_width)
    )
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reference_two_step_decode():
    """Port of tests/test_decoding.rs:14-51 (T=4, W=3, rows [0.8, 0.2])."""
    T, W = 4, 3
    h = np.log(np.full((W, 2), [0.8, 0.2], np.float32))
    lph = np.zeros(W, np.float32)
    fin = np.zeros(W, bool)
    t = np.zeros(W, np.int32)
    u = np.zeros(W, np.int32)

    r1 = run_jax(h, lph, fin, t, u, T)
    # Step 1: three identical beams expand to {emit lp=ln0.8, shift lp=ln0.2};
    # dedup collapses identical candidates -> 2 survivors + 1 repeat pad.
    np.testing.assert_allclose(
        r1["log_prob"],
        np.log(np.array([0.8, 0.2, 0.8], np.float32)),
        rtol=1e-6,
    )
    np.testing.assert_array_equal(r1["prediction"], [0, 1, 0])
    np.testing.assert_array_equal(r1["next_t"], [0, 1, 0])
    np.testing.assert_array_equal(r1["next_u"], [1, 1, 1])
    np.testing.assert_array_equal(r1["beam_branch"], [0, 0, 0])
    assert not r1["is_finished"].any()

    # Step 2 feeds step-1 log-probs back in (reference keeps t=u=0 inputs).
    r2 = run_jax(h, r1["log_prob"], fin, t, u, T)
    want = oracle.candidates_to_arrays(
        oracle.v1_beam_search_kernel(h, r1["log_prob"], fin, t, u, T, W)
    )
    for k in want:
        np.testing.assert_array_equal(r2[k], want[k], err_msg=k)
    # Top candidate: emit from the best beam, lp = ln(0.8) + ln(0.8).
    np.testing.assert_allclose(
        r2["log_prob"][0], np.log(np.float32(0.8)) * 2, rtol=1e-6
    )


def test_last_frame_semantics():
    """Emit at t=T-1 finishes; Shift at t=T-1 is converted to a no-prob
    finishing Emit (src/lib.rs:187-205)."""
    T, W = 3, 2
    h = np.log(np.array([[0.6, 0.4], [0.7, 0.3]], np.float32))
    lph = np.array([-1.0, -2.0], np.float32)
    fin = np.zeros(W, bool)
    t = np.full(W, T - 1, np.int32)
    u = np.array([5, 6], np.int32)
    assert_matches_oracle(h, lph, fin, t, u, T, W)
    got = run_jax(h, lph, fin, t, u, T)
    assert got["is_finished"].all()
    assert (got["prediction"] == 0).all()


def test_finished_and_out_of_range_padding():
    """Finished/out-of-range beams emit the padding candidate
    (src/lib.rs:174-184)."""
    T, W = 4, 3
    h = np.log(np.random.default_rng(1).uniform(0.1, 0.9, (W, 2))).astype(
        np.float32
    )
    lph = np.array([-0.5, -1.5, -2.5], np.float32)
    fin = np.array([True, False, False])
    t = np.array([1, 7, 2], np.int32)  # beam 1 out of range
    u = np.array([3, 4, 5], np.int32)
    assert_matches_oracle(h, lph, fin, t, u, T, W)


@pytest.mark.parametrize("seed", range(8))
def test_randomized_conformance(seed):
    rng = np.random.default_rng(seed)
    W = int(rng.integers(1, 9))
    T = int(rng.integers(1, 6))
    max_w = W
    h = np.log(rng.uniform(0.05, 1.0, (W, 2))).astype(np.float32)
    # Duplicate some log-prob histories to exercise dedup ties.
    lph = rng.choice(
        np.array([-0.25, -0.5, -1.0], np.float32), W
    ).astype(np.float32)
    fin = rng.uniform(size=W) < 0.2
    t = rng.integers(0, T + 2, W).astype(np.int32)
    u = rng.integers(0, 6, W).astype(np.int32)
    assert_matches_oracle(h, lph, fin, t, u, T, max_w)


def test_dedup_ties_match_reference_order():
    """Identical beams create exact-duplicate candidates; survivors and the
    pad-by-repetition must match the reference ordering exactly."""
    T, W = 5, 4
    h = np.log(np.full((W, 2), [0.5, 0.5], np.float32))
    lph = np.zeros(W, np.float32)
    fin = np.zeros(W, bool)
    t = np.zeros(W, np.int32)
    u = np.zeros(W, np.int32)
    assert_matches_oracle(h, lph, fin, t, u, T, W)


def test_batched_wrapper():
    B, W, T = 3, 4, 5
    rng = np.random.default_rng(2)
    h = np.log(rng.uniform(0.05, 1.0, (B, W, 2))).astype(np.float32)
    lph = np.zeros((B, W), np.float32)
    fin = np.zeros((B, W), bool)
    t = np.zeros((B, W), np.int32)
    u = np.zeros((B, W), np.int32)
    T_b = np.full((B,), T, np.int32)
    outs = _batched(
        jnp.asarray(h), jnp.asarray(lph), jnp.asarray(fin),
        jnp.asarray(t), jnp.asarray(u), jnp.asarray(T_b),
    )
    for b in range(B):
        want = oracle.candidates_to_arrays(
            oracle.v1_beam_search_kernel(
                h[b], lph[b], fin[b], t[b], u[b], T, W
            )
        )
        names = ["prediction", "log_prob", "next_t", "next_u", "is_finished",
                 "beam_branch"]
        for k, got in zip(names, outs):
            np.testing.assert_array_equal(np.asarray(got)[b], want[k],
                                          err_msg=f"b={b} {k}")


def test_widening_beam_loop():
    """Multi-step decode loop exercising the pad-to-max generality
    (src/lib.rs:163-167): the first step widens W_in=2 -> W_out=5 by
    pad-by-repetition, and every later step runs at the widened width.
    Each step is conformance-checked against the numpy oracle, feeding
    the previous step's outputs back in (the reference call shape,
    SURVEY.md §3.2)."""
    T, W_in, W_out = 6, 2, 5
    rng = np.random.default_rng(7)

    lph = np.zeros(W_in, np.float32)
    fin = np.zeros(W_in, bool)
    t = np.zeros(W_in, np.int32)
    u = np.zeros(W_in, np.int32)

    widened_once = False
    for step_i in range(7):
        W_cur = len(lph)
        h = np.log(rng.uniform(0.05, 1.0, (W_cur, 2))).astype(np.float32)
        got = run_jax(h, lph, fin, t, u, T, max_beam_width=W_out)
        want = oracle.candidates_to_arrays(
            oracle.v1_beam_search_kernel(h, lph, fin, t, u, T, W_out)
        )
        for k in want:
            np.testing.assert_array_equal(
                got[k], want[k], err_msg=f"step {step_i} {k}"
            )
        assert got["log_prob"].shape == (W_out,)
        if step_i == 0:
            # The widening step must pad by repeating top hypotheses.
            assert W_cur == W_in
            widened_once = True
        lph = got["log_prob"]
        fin = got["is_finished"]
        t = got["next_t"]
        u = got["next_u"]
    assert widened_once
    # The widened beam persisted through every later step.
    assert lph.shape == (W_out,) and t.shape == (W_out,)


def test_negative_zero_log_prob_tie_order():
    """-0.0 must tie +0.0 with generation order deciding (IEEE ==, like the
    reference's stable sort). This is the case where `lax.top_k` diverges on
    backends whose TopK uses a bit-pattern total order (+0.0 strictly
    before -0.0), so
    the sort-free pairwise-rank selection (ops/beam_common.py) is required
    for backend-independent reference exactness. A finished beam holding
    log_prob -0.0 emits a padding candidate that must outrank a later
    active candidate landing exactly on +0.0.
    """
    T = 10
    # Beam 0: finished with cumulative log_prob -0.0 -> padding candidate
    #   (gen index 0, log_prob -0.0).
    # Beam 1: active with history -1.5 and emit log-prob +1.5 -> candidate
    #   at exactly +0.0 (gen index 2).
    h = np.array([[0.0, 0.0], [1.5, -5.0]], np.float32)
    lph = np.array([-0.0, -1.5], np.float32)
    fin = np.array([True, False])
    t = np.array([3, 4], np.int32)
    u = np.array([2, 2], np.int32)
    assert np.signbit(lph[0])
    got = run_jax(h, lph, fin, t, u, T)
    want = oracle.candidates_to_arrays(
        oracle.v1_beam_search_kernel(h, lph, fin, t, u, T, 2)
    )
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # The -0.0 padding candidate (from finished beam 0) precedes the +0.0
    # active candidate.
    assert got["beam_branch"][0] == 0 and bool(got["is_finished"][0])
    assert got["beam_branch"][1] == 1 and not bool(got["is_finished"][1])
