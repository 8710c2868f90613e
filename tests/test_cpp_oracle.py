"""Conformance: JAX ops == C++ CPU oracle == numpy oracle.

This is the native-layer conformance harness (SURVEY.md §7 step 3) and the
BASELINE config-0/1 check: SSNT loss+grad on (T=50, U=20) and a batched
masked case vs the double-precision C++ forward-backward.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ssnt_tts.ops import beam_v1, beam_v2, edit_distance, lattice
from ssnt_tts.ops import tone_latent as tone_ops
from ssnt_tts.oracle import build as cpp
from ssnt_tts.oracle import numpy_oracle as pyo


def test_cpp_builds():
    assert cpp.load() is not None


def test_v1_three_way(rng):
    B, W, T = 3, 5, 6
    h = np.log(rng.uniform(0.05, 1.0, (B, W, 2))).astype(np.float32)
    lph = rng.choice(np.array([-0.5, -1.0], np.float32), (B, W))
    fin = rng.uniform(size=(B, W)) < 0.2
    t = rng.integers(0, T + 1, (B, W)).astype(np.int32)
    u = rng.integers(0, 5, (B, W)).astype(np.int32)
    il = np.full(B, T, np.int32)

    c_out = cpp.v1_beam_step(h, lph, fin, t, u, il)
    j_out = jax.jit(beam_v1.beam_search_decode_batched)(
        jnp.asarray(h), jnp.asarray(lph), jnp.asarray(fin),
        jnp.asarray(t), jnp.asarray(u), jnp.asarray(il),
    )
    for name, c, j in zip(
        ["pred", "lp", "t", "u", "fin", "branch"], c_out, j_out
    ):
        np.testing.assert_array_equal(np.asarray(j), c, err_msg=name)
    for b in range(B):
        py = pyo.candidates_to_arrays(
            pyo.v1_beam_search_kernel(h[b], lph[b], fin[b], t[b], u[b], T, W)
        )
        np.testing.assert_array_equal(c_out[0][b], py["prediction"])
        np.testing.assert_array_equal(c_out[1][b], py["log_prob"])


def test_v2_three_way(rng):
    B, W, D = 4, 4, 5
    T, U = 8, 30
    h = np.log(rng.uniform(0.05, 1.0, (B, W, D))).astype(np.float32)
    dur = np.array([0, 2, 3, 4, 5], np.int32)
    lph = -rng.uniform(0, 2, (B, W)).astype(np.float32)
    fin = np.zeros((B, W), bool)
    t = rng.integers(0, 4, (B, W)).astype(np.int32)
    u = t.copy()
    diag = (U / T * (t + 1)).astype(np.int32)
    tot = np.clip(diag + rng.integers(-3, 4, (B, W)), 0, U).astype(np.int32)
    il = np.full(B, T, np.int32)
    ol = np.full(B, U, np.int32)

    (c_out, empties) = cpp.v2_beam_step(
        h, lph, fin, tot, dur, t, u, il, ol, 0, False, False
    )
    assert empties == 0
    j_out = jax.jit(
        beam_v2.beam_search_decode,
        static_argnames=("zero_duration_id", "allow_skip", "test_mode"),
    )(
        jnp.asarray(h), jnp.asarray(lph), jnp.asarray(fin), jnp.asarray(tot),
        jnp.asarray(dur), jnp.asarray(t), jnp.asarray(u), jnp.asarray(il),
        jnp.asarray(ol), zero_duration_id=0, allow_skip=False,
        test_mode=False,
    )
    for name, c, j in zip(
        ["pred", "lp", "t", "u", "fin", "tot", "branch"], c_out, j_out
    ):
        np.testing.assert_array_equal(np.asarray(j), c, err_msg=name)
    for b in range(B):
        py = pyo.candidates_to_arrays(
            pyo.v2_beam_search_kernel(
                h[b], lph[b], fin[b], tot[b], dur, t[b], u[b], T, U,
                0, False, False, W,
            ),
            with_duration=True,
        )
        np.testing.assert_array_equal(c_out[0][b], py["prediction"])
        np.testing.assert_array_equal(c_out[6][b], py["beam_branch"])


def test_tone_three_way(rng):
    B, W, K, T = 3, 4, 6, 7
    h = np.log(rng.uniform(0.05, 1.0, (B, W, K))).astype(np.float32)
    lph = np.zeros((B, W), np.float32)
    fin = rng.uniform(size=(B, W)) < 0.2
    t = rng.integers(0, T + 1, (B, W)).astype(np.int32)
    u = rng.integers(0, 5, (B, W)).astype(np.int32)
    il = np.full(B, T, np.int32)
    c_out = cpp.tone_beam_step(h, lph, fin, t, u, il, K - 1)
    j_out = jax.jit(
        tone_ops.beam_search_decode, static_argnames=("empty_tone_id",)
    )(
        jnp.asarray(h), jnp.asarray(lph), jnp.asarray(fin), jnp.asarray(t),
        jnp.asarray(u), jnp.asarray(il), empty_tone_id=K - 1,
    )
    for name, c, j in zip(
        ["pred", "lp", "t", "u", "fin", "branch"], c_out, j_out
    ):
        np.testing.assert_array_equal(np.asarray(j), c, err_msg=name)


def test_backtrace_upsample_editdist_vs_cpp(rng):
    from ssnt_tts.ops import backtrace, upsample

    B, U, W = 2, 9, 4
    bb = rng.integers(0, W, (B, U, W)).astype(np.int32)
    th = rng.integers(0, 15, (B, U, W)).astype(np.int32)
    finals = rng.integers(0, W, B).astype(np.int32)
    cb, ct = cpp.extract_best_beam_branch(finals, bb, th)
    jb, jt = jax.jit(backtrace.extract_best_beam_branch)(
        jnp.asarray(finals), jnp.asarray(bb), jnp.asarray(th)
    )
    np.testing.assert_array_equal(np.asarray(jb), cb)
    np.testing.assert_array_equal(np.asarray(jt), ct)

    Tn = 7
    obb = rng.integers(0, W, (B, Tn, W)).astype(np.int32)
    ofin = rng.integers(0, W, (B, W)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(backtrace.order_beam_branch)(
            jnp.asarray(ofin), jnp.asarray(obb))),
        cpp.order_beam_branch(ofin, obb),
    )

    duration = rng.integers(0, 4, (B, W, Tn)).astype(np.int32)
    ol = duration.sum(-1).astype(np.int32)
    mu = max(int(ol.max()), 1)
    np.testing.assert_array_equal(
        np.asarray(upsample.upsample_source_indexes(
            jnp.asarray(duration), jnp.asarray(ol), -1, max_u=mu)),
        cpp.upsample(duration, ol, mu, -1),
    )

    L = 8
    a = rng.integers(0, 4, (B, L)).astype(np.int32)
    bseq = rng.integers(0, 4, (B, L)).astype(np.int32)
    al = rng.integers(0, L + 1, B).astype(np.int32)
    bl = rng.integers(0, L + 1, B).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(edit_distance.levenshtein_edit_distance)(
            jnp.asarray(a), jnp.asarray(bseq), jnp.asarray(al),
            jnp.asarray(bl))),
        cpp.edit_distance(a, bseq, al, bl),
    )


def test_ssnt_loss_grad_vs_cpp_T50_U20():
    """BASELINE config 0: single-utterance loss+grad fp32 allclose vs the CPU
    oracle — note T=50 source positions requires U>=T; the baseline's
    (T=50, U=20) names mel frames T and tokens U, i.e. 20 source tokens and
    50 output frames in this framework's convention."""
    rng = np.random.default_rng(0)
    B, T, U = 1, 20, 50
    le = np.log(rng.uniform(0.1, 0.9, (B, T, U))).astype(np.float32)
    ls = np.log1p(-np.exp(le)).astype(np.float32)
    lf = rng.normal(0, 0.5, (B, T, U)).astype(np.float32)
    il = np.full(B, T, np.int32)
    ol = np.full(B, U, np.int32)

    c_loss, c_ge, c_gs, c_gf = cpp.ssnt_loss_grad(le, ls, lf, il, ol)
    j_loss = np.asarray(jax.jit(lattice.ssnt_loss)(le, ls, lf, il, ol))
    j_ge, j_gs, j_gf = jax.jit(
        jax.grad(
            lambda a, b, c: jnp.sum(lattice.ssnt_loss(a, b, c, il, ol)),
            argnums=(0, 1, 2),
        )
    )(le, ls, lf)
    np.testing.assert_allclose(j_loss, c_loss, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(j_ge), c_ge, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(np.asarray(j_gs), c_gs, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(np.asarray(j_gf), c_gf, rtol=2e-3, atol=2e-4)


def test_ssnt_loss_grad_vs_cpp_batched_masked():
    """BASELINE config 1 (shrunk for CPU CI): batched ragged lattice."""
    rng = np.random.default_rng(1)
    B, T, U = 4, 12, 40
    le = np.log(rng.uniform(0.1, 0.9, (B, T, U))).astype(np.float32)
    ls = np.log1p(-np.exp(le)).astype(np.float32)
    lf = rng.normal(0, 0.5, (B, T, U)).astype(np.float32)
    il = np.array([12, 9, 11, 7], np.int32)
    ol = np.array([40, 30, 25, 18], np.int32)
    c_loss, c_ge, c_gs, c_gf = cpp.ssnt_loss_grad(le, ls, lf, il, ol)
    j_loss = np.asarray(jax.jit(lattice.ssnt_loss)(le, ls, lf, il, ol))
    j_ge, j_gs, j_gf = jax.jit(
        jax.grad(
            lambda a, b, c: jnp.sum(lattice.ssnt_loss(a, b, c, il, ol)),
            argnums=(0, 1, 2),
        )
    )(le, ls, lf)
    np.testing.assert_allclose(j_loss, c_loss, rtol=2e-4, atol=2e-4)
    for j, c in [(j_ge, c_ge), (j_gs, c_gs), (j_gf, c_gf)]:
        np.testing.assert_allclose(np.asarray(j), c, rtol=2e-3, atol=2e-4)
