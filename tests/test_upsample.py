"""Upsampling: golden test ported from the reference Python suite
(/root/reference/ssnt-tts-tensorflow/tests/test_upsample_source_indexes.py)
plus oracle conformance.
"""

import numpy as np
import jax
import jax.numpy as jnp

from ssnt_tts.ops import upsample
from ssnt_tts.oracle import numpy_oracle as oracle


def test_golden_reference_case():
    """3x2x6 durations -> 3x2x11 indices with -1 out-of-range fill, matching
    the reference golden test's structure."""
    duration = np.array(
        [
            [[1, 2, 3, 1, 2, 2], [2, 2, 2, 2, 2, 1]],
            [[3, 3, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1]],
            [[2, 0, 4, 0, 3, 2], [0, 5, 0, 4, 0, 2]],
        ],
        np.int32,
    )
    output_length = duration.sum(axis=-1).astype(np.int32)
    max_u = int(output_length.max())
    assert max_u == 11
    got = upsample.upsample_source_indexes(
        jnp.asarray(duration), jnp.asarray(output_length), -1, max_u=max_u
    )
    want = oracle.upsample_source_indexes(duration, output_length, max_u, -1)
    np.testing.assert_array_equal(np.asarray(got), want)
    # Spot-check the repeat-expansion semantics directly.
    np.testing.assert_array_equal(
        np.asarray(got)[0, 0], [0, 1, 1, 2, 2, 2, 3, 4, 4, 5, 5]
    )
    # Zero durations are skipped (src/v2_util.rs:51-56).
    np.testing.assert_array_equal(
        np.asarray(got)[2, 1], [1, 1, 1, 1, 1, 3, 3, 3, 3, 5, 5]
    )


def test_out_of_range_fill():
    duration = np.array([[[2, 1, 0]]], np.int32)
    output_length = np.array([[3]], np.int32)
    got = upsample.upsample_source_indexes(
        jnp.asarray(duration), jnp.asarray(output_length), -1, max_u=6
    )
    np.testing.assert_array_equal(np.asarray(got)[0, 0], [0, 0, 1, -1, -1, -1])


def test_randomized_conformance():
    rng = np.random.default_rng(0)
    for _ in range(5):
        B, W, T = 2, 3, int(rng.integers(1, 8))
        duration = rng.integers(0, 4, (B, W, T)).astype(np.int32)
        output_length = duration.sum(axis=-1).astype(np.int32)
        max_u = max(int(output_length.max()), 1)
        got = upsample.upsample_source_indexes(
            jnp.asarray(duration), jnp.asarray(output_length), -7, max_u=max_u
        )
        want = oracle.upsample_source_indexes(
            duration, output_length, max_u, -7
        )
        np.testing.assert_array_equal(np.asarray(got), want)
