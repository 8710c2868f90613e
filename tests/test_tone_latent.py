"""Tone-latent beam step: oracle conformance (reference leaves it untested)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ssnt_tts.ops import tone_latent
from ssnt_tts.oracle import numpy_oracle as oracle

_NAMES = ["prediction", "log_prob", "next_t", "next_u", "is_finished",
          "beam_branch"]

_step = jax.jit(
    tone_latent.beam_search_step,
    static_argnames=("empty_tone_id", "max_beam_width"),
)


def assert_matches_oracle(h, lph, fin, t, u, T, empty_tone_id):
    W = h.shape[0]
    outs = _step(
        jnp.asarray(h, jnp.float32), jnp.asarray(lph, jnp.float32),
        jnp.asarray(fin), jnp.asarray(t, jnp.int32),
        jnp.asarray(u, jnp.int32), T, empty_tone_id=empty_tone_id,
    )
    want = oracle.candidates_to_arrays(
        oracle.tone_beam_search_kernel(h, lph, fin, t, u, T, empty_tone_id, W)
    )
    for k, got in zip(_NAMES, outs):
        np.testing.assert_array_equal(np.asarray(got), want[k], err_msg=k)


def test_basic_expansion():
    W, K, T = 3, 5, 8
    rng = np.random.default_rng(0)
    h = np.log(rng.uniform(0.05, 1.0, (W, K))).astype(np.float32)
    assert_matches_oracle(
        h, np.zeros(W, np.float32), np.zeros(W, bool),
        np.zeros(W, np.int32), np.zeros(W, np.int32), T, K - 1,
    )


def test_finished_and_out_of_range():
    W, K, T = 3, 4, 5
    rng = np.random.default_rng(1)
    h = np.log(rng.uniform(0.05, 1.0, (W, K))).astype(np.float32)
    lph = -rng.uniform(0, 2, W).astype(np.float32)
    fin = np.array([True, False, False])
    t = np.array([2, 6, 3], np.int32)  # beam 1 out of range
    u = np.array([2, 3, 4], np.int32)
    assert_matches_oracle(h, lph, fin, t, u, T, K - 1)


@pytest.mark.parametrize("seed", range(8))
def test_randomized_conformance(seed):
    rng = np.random.default_rng(200 + seed)
    W = int(rng.integers(1, 7))
    K = int(rng.integers(2, 8))
    T = int(rng.integers(1, 10))
    h = np.log(rng.uniform(0.05, 1.0, (W, K))).astype(np.float32)
    lph = rng.choice(np.array([-0.5, -1.0], np.float32), W)
    fin = rng.uniform(size=W) < 0.2
    t = rng.integers(0, T + 2, W).astype(np.int32)
    u = rng.integers(0, 6, W).astype(np.int32)
    assert_matches_oracle(h, lph, fin, t, u, T, K - 1)


def test_batched_wrapper():
    B, W, K = 3, 4, 5
    rng = np.random.default_rng(5)
    T = np.array([4, 6, 8], np.int32)
    h = np.log(rng.uniform(0.05, 1.0, (B, W, K))).astype(np.float32)
    lph = np.zeros((B, W), np.float32)
    fin = np.zeros((B, W), bool)
    t = np.zeros((B, W), np.int32)
    u = np.zeros((B, W), np.int32)
    outs = jax.jit(
        tone_latent.beam_search_decode, static_argnames=("empty_tone_id",)
    )(
        jnp.asarray(h), jnp.asarray(lph), jnp.asarray(fin),
        jnp.asarray(t), jnp.asarray(u), jnp.asarray(T), empty_tone_id=0,
    )
    for b in range(B):
        want = oracle.candidates_to_arrays(
            oracle.tone_beam_search_kernel(
                h[b], lph[b], fin[b], t[b], u[b], int(T[b]), 0, W
            )
        )
        for k, got in zip(_NAMES, outs):
            np.testing.assert_array_equal(np.asarray(got)[b], want[k],
                                          err_msg=f"b={b} {k}")
