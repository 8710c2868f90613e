"""Functional error checking (checkify) for invariants the reference enforced
with process-killing asserts/panics.

Reference failure modes (SURVEY.md §5):
  - v2 empty beam -> panic (src/v2.rs:292)
  - upsample sum(duration) != output_length -> assert (src/v2_util.rs:58)

On an accelerator a panic would take down the whole job; these wrappers return a
checkify Error alongside the result so callers decide (mask the lane, drop
the utterance, or raise on host).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from ssnt_tts.ops import beam_v2, upsample


def v2_beam_search_step_checked(*args, **kwargs):
    """v2 step that errors (via checkify) when the beam empties, mirroring
    the reference panic. Returns (error, outputs)."""

    def fn(*a, **k):
        outs = beam_v2.beam_search_step(
            *a, **k, return_num_survivors=True
        )
        n = outs[-1]
        checkify.check(
            n > 0,
            "Beam search could not find a duration sequence with compatible "
            "output length (reference panics here, src/v2.rs:292).",
        )
        return outs[:-1]

    return checkify.checkify(fn)(*args, **kwargs)


def upsample_source_indexes_checked(duration, output_length,
                                    out_of_range_source_index,
                                    max_u=None):
    """Upsampling that checks sum(duration) == output_length per (b, w)
    (reference assert, src/v2_util.rs:58). Returns (error, indices)."""

    def fn(duration, output_length):
        total = jnp.sum(duration, axis=-1)
        checkify.check(
            jnp.all(total == output_length),
            "sum(duration) != output_length (reference assert, "
            "src/v2_util.rs:58)",
        )
        return upsample.upsample_source_indexes(
            duration, output_length, out_of_range_source_index, max_u=max_u
        )

    return checkify.checkify(fn)(duration, output_length)
