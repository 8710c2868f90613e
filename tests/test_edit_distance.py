"""Levenshtein edit distance: Kaldi test vectors ported bit-exactly from
/root/reference/tests/test_edit_distance.rs plus randomized conformance.
"""

import numpy as np
import jax
import jax.numpy as jnp

from ssnt_tts.ops import edit_distance
from ssnt_tts.oracle import numpy_oracle as oracle

_batched = jax.jit(edit_distance.levenshtein_edit_distance)


def dist_pair(a, b, L=8):
    """Single-pair helper via the batched op with padding."""
    pa = np.full(L, -99, np.int32)
    pb = np.full(L, -98, np.int32)
    pa[: len(a)] = a
    pb[: len(b)] = b
    out = _batched(
        jnp.asarray(pa[None]), jnp.asarray(pb[None]),
        jnp.asarray([len(a)], np.int32), jnp.asarray([len(b)], np.int32),
    )
    return int(np.asarray(out)[0])


def test_kaldi_vectors():
    """tests/test_edit_distance.rs:10-69."""
    assert dist_pair([], []) == 0
    assert dist_pair([1], [1]) == 0
    assert dist_pair([1, 2], [1, 2]) == 0
    assert dist_pair([1], []) == 1
    assert dist_pair([1], [1, 2]) == 1
    assert dist_pair([1, 2, 3, 4], [1, 2, 4]) == 1
    assert dist_pair([1, 2, 3, 4, 5], [1, 2, 4]) == 2
    assert dist_pair([1, 2, 3, 4, 5], [1, 2, 4, 6]) == 2
    assert dist_pair([1, 2, 3, 4, 5, 1], [1, 2, 4, 6, 1]) == 2
    assert dist_pair([1, 2, 3, 4, 5, 1], [1, 2, 4, 6, 1, 10]) == 3


def test_batched_golden():
    """tests/test_edit_distance.rs:72-107 (10x6 variable-length batch)."""
    a = np.array(
        [
            [-1, -2, -3, -4, -5, -6],
            [1, -1, -2, -3, -4, -5],
            [1, 2, -1, -2, -3, -4],
            [1, -1, -2, -3, -4, -5],
            [1, -1, -2, -3, -4, -5],
            [1, 2, 3, 4, -1, -2],
            [1, 2, 3, 4, 5, -1],
            [1, 2, 3, 4, 5, -1],
            [1, 2, 3, 4, 5, 1],
            [1, 2, 3, 4, 5, 1],
        ],
        np.int32,
    )
    a_len = np.array([0, 1, 2, 1, 1, 4, 5, 5, 6, 6], np.int32)
    b = np.array(
        [
            [-1, -1, -1, -1, -1, -1],
            [1, -1, -1, -1, -1, -1],
            [1, 2, -1, -1, -1, -1],
            [-6, -5, -4, -3, -2, -1],
            [1, 2, -1, -1, -1, -1],
            [1, 2, 4, -3, -2, -1],
            [1, 2, 4, -3, -2, -1],
            [1, 2, 4, 6, -2, -1],
            [1, 2, 4, 6, 1, -1],
            [1, 2, 4, 6, 1, 10],
        ],
        np.int32,
    )
    b_len = np.array([0, 1, 2, 0, 2, 3, 3, 4, 5, 6], np.int32)
    got = _batched(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(a_len), jnp.asarray(b_len)
    )
    np.testing.assert_array_equal(
        np.asarray(got), [0, 0, 0, 1, 1, 1, 2, 2, 2, 3]
    )


def test_randomized_conformance():
    rng = np.random.default_rng(0)
    B, L = 16, 10
    a = rng.integers(0, 4, (B, L)).astype(np.int32)
    b = rng.integers(0, 4, (B, L)).astype(np.int32)
    a_len = rng.integers(0, L + 1, B).astype(np.int32)
    b_len = rng.integers(0, L + 1, B).astype(np.int32)
    got = _batched(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(a_len), jnp.asarray(b_len)
    )
    want = oracle.levenshtein_edit_distance(a, b, a_len, b_len)
    np.testing.assert_array_equal(np.asarray(got), want)
