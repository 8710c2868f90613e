"""Backtrace ops: the reference's strongest golden test
(tests/test_decoding.rs:54-131) ported bit-exactly, plus oracle conformance
for order_beam_branch (untested in the reference).
"""

import numpy as np
import jax
import jax.numpy as jnp

from ssnt_tts.ops import backtrace
from ssnt_tts.oracle import numpy_oracle as oracle

# 60x10 parent-pointer table from /root/reference/tests/test_decoding.rs:57-118.
GOLDEN_TABLE = [
    [0, 3, 0, 5, 2, 3, 4, 1, 1, 9],
    [0, 5, 0, 1, 1, 3, 2, 2, 3, 4],
    [0, 5, 0, 1, 2, 3, 4, 2, 1, 3],
    [8, 3, 0, 0, 7, 1, 2, 1, 3, 4],
    [0, 0, 1, 1, 2, 3, 4, 5, 6, 7],
    [1, 0, 1, 2, 3, 4, 5, 0, 3, 6],
    [0, 0, 7, 1, 8, 3, 4, 5, 6, 2],
    [0, 0, 1, 1, 4, 2, 3, 5, 2, 6],
    [0, 1, 0, 2, 2, 3, 4, 6, 4, 5],
    [0, 4, 0, 1, 3, 2, 4, 2, 5, 6],
    [0, 7, 0, 1, 2, 1, 3, 4, 6, 8],
    [0, 0, 2, 1, 4, 1, 3, 5, 3, 6],
    [3, 1, 0, 5, 0, 6, 2, 4, 3, 5],
    [0, 4, 5, 0, 1, 2, 3, 4, 3, 6],
    [0, 0, 1, 2, 1, 2, 3, 4, 5, 7],
    [0, 1, 1, 3, 2, 2, 3, 4, 5, 6],
    [2, 3, 0, 1, 2, 3, 4, 5, 5, 6],
    [7, 0, 0, 2, 1, 3, 4, 5, 6, 1],
    [1, 9, 0, 2, 1, 0, 3, 4, 5, 6],
    [0, 0, 1, 2, 3, 1, 4, 5, 6, 7],
    [1, 0, 1, 3, 4, 5, 2, 7, 6, 2],
    [0, 0, 1, 2, 7, 3, 4, 5, 6, 8],
    [0, 0, 1, 2, 3, 4, 4, 5, 6, 7],
    [0, 1, 0, 2, 3, 4, 5, 6, 7, 8],
    [2, 0, 1, 2, 3, 4, 5, 6, 7, 8],
    [0, 0, 1, 2, 3, 4, 5, 6, 7, 8],
    [0, 0, 1, 2, 3, 4, 5, 6, 7, 8],
    [0, 1, 1, 2, 3, 4, 5, 6, 7, 8],
    [0, 1, 2, 1, 3, 4, 5, 6, 7, 8],
    [3, 0, 1, 2, 3, 4, 5, 6, 7, 8],
    [0, 0, 1, 2, 3, 4, 5, 6, 7, 8],
    [1, 2, 0, 3, 0, 4, 5, 6, 7, 8],
    [4, 0, 1, 2, 3, 5, 4, 6, 7, 8],
    [0, 0, 1, 2, 3, 4, 5, 6, 7, 8],
    [1, 0, 1, 2, 3, 4, 5, 6, 7, 8],
    [0, 0, 1, 2, 3, 4, 5, 6, 7, 8],
    [1, 0, 1, 2, 3, 4, 5, 6, 7, 8],
    [0, 0, 1, 2, 3, 4, 5, 6, 7, 8],
    [0, 0, 1, 2, 3, 4, 5, 6, 7, 8],
    [0, 1, 0, 2, 3, 4, 5, 6, 7, 8],
    [0, 1, 2, 2, 3, 4, 5, 6, 7, 8],
    [0, 1, 2, 3, 4, 3, 5, 6, 7, 8],
    [0, 1, 2, 3, 4, 5, 6, 7, 5, 8],
    [0, 1, 2, 8, 3, 4, 5, 6, 7, 8],
    [0, 1, 2, 3, 4, 3, 5, 6, 7, 8],
    [0, 1, 2, 3, 4, 5, 5, 6, 7, 8],
    [0, 1, 2, 3, 5, 4, 5, 6, 7, 8],
    [0, 1, 2, 4, 3, 4, 5, 6, 7, 8],
    [0, 1, 2, 3, 3, 4, 5, 6, 7, 8],
    [0, 1, 2, 3, 4, 4, 5, 6, 7, 8],
    [0, 1, 2, 3, 5, 4, 5, 6, 7, 8],
    [0, 1, 2, 3, 4, 5, 6, 4, 7, 8],
    [0, 1, 2, 3, 4, 5, 6, 7, 7, 8],
    [0, 1, 2, 3, 7, 4, 5, 6, 7, 8],
    [0, 1, 2, 3, 4, 5, 4, 6, 7, 8],
    [0, 1, 2, 3, 4, 5, 6, 7, 6, 8],
    [0, 8, 1, 2, 3, 4, 5, 6, 7, 8],
    [0, 1, 2, 1, 3, 4, 5, 6, 7, 8],
    [0, 1, 2, 3, 4, 5, 6, 3, 7, 8],
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9],
]

GOLDEN_EXPECTED = [
    5, 1, 8, 0, 1, 0, 0, 0, 2, 7,
    1, 3, 0, 0, 1, 2, 0, 1, 0, 1,
    0, 0, 0, 2, 0, 0, 1, 1, 3, 0,
    0, 4, 0, 1, 0, 1, 0, 0, 0, 2,
    3, 5, 8, 3, 5, 5, 4, 3, 4, 5,
    4, 7, 7, 4, 6, 6, 7, 8, 9, 9,
]


def test_golden_extract_best_beam_branch():
    """Bit-exact port of tests/test_decoding.rs:54-131 (the reference's
    strongest golden test)."""
    table = jnp.asarray(GOLDEN_TABLE, jnp.int32)
    branches, ts = jax.jit(backtrace.extract_best_beam_branch_kernel)(
        9, table, table
    )
    np.testing.assert_array_equal(np.asarray(branches), GOLDEN_EXPECTED)
    # t_history == beam_branch table in the reference test, so best_t must
    # equal gathering the table along the recovered path.
    want_b, want_t = oracle.extract_best_beam_branch_kernel(
        9, GOLDEN_TABLE, GOLDEN_TABLE
    )
    np.testing.assert_array_equal(np.asarray(branches), want_b)
    np.testing.assert_array_equal(np.asarray(ts), want_t)


def test_batched_extract():
    rng = np.random.default_rng(0)
    B, U, W = 3, 12, 5
    bb = rng.integers(0, W, (B, U, W)).astype(np.int32)
    th = rng.integers(0, 20, (B, U, W)).astype(np.int32)
    finals = rng.integers(0, W, B).astype(np.int32)
    got_b, got_t = jax.jit(backtrace.extract_best_beam_branch)(
        jnp.asarray(finals), jnp.asarray(bb), jnp.asarray(th)
    )
    for b in range(B):
        want_b, want_t = oracle.extract_best_beam_branch_kernel(
            finals[b], bb[b].tolist(), th[b].tolist()
        )
        np.testing.assert_array_equal(np.asarray(got_b)[b], want_b)
        np.testing.assert_array_equal(np.asarray(got_t)[b], want_t)


def test_order_beam_branch():
    rng = np.random.default_rng(1)
    B, T, W = 4, 9, 6
    bb = rng.integers(0, W, (B, T, W)).astype(np.int32)
    finals = rng.integers(0, W, (B, W)).astype(np.int32)
    got = jax.jit(backtrace.order_beam_branch)(
        jnp.asarray(finals), jnp.asarray(bb)
    )
    want = oracle.order_beam_branch(finals, bb)
    np.testing.assert_array_equal(np.asarray(got), want)
