"""Beam backtrace / alignment extraction (on-device).

Reference semantics:
  - extract_best_beam_branch (/root/reference/src/util.rs:6-33): given the
    best final branch id, walk the (U, W) parent-pointer table backwards
    recovering the branch-id sequence and its t_history.
  - order_beam_branch (/root/reference/src/v2_util.rs:6-36): the same walk for
    *every* beam, (B, T, W) parents -> (B, W, T) ordered ancestry.

Both become reverse `lax.scan`s over the step axis — the parent-pointer walk
is inherently sequential in steps but fully parallel across batch and beams
(vmap), so the whole extraction stays on device after decode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def extract_best_beam_branch_kernel(best_final_branch, beam_branch, t_history):
    """Single-utterance backtrace (src/util.rs:20-33).

    beam_branch, t_history: (U, W) i32; best_final_branch: scalar i32.
    Returns (best_beam_branch (U,), best_t_history (U,)).
    """
    beam_branch = beam_branch.astype(jnp.int32)
    t_history = t_history.astype(jnp.int32)

    def step(current, row):
        branch_row, t_row = row
        current_t = t_row[current]
        prev = branch_row[current]
        return prev, (current, current_t)

    _, (branches, ts) = jax.lax.scan(
        step,
        jnp.asarray(best_final_branch, jnp.int32),
        (beam_branch, t_history),
        reverse=True,
    )
    return branches, ts


def extract_best_beam_branch(best_final_branch, beam_branch, t_history,
                             beam_width: int | None = None):
    """Batched backtrace (src/util.rs:6-18). beam_branch/t_history: (B, U, W)
    (or unbatched (U, W) for TF-op parity, ssnt_extract_best_beam_branch_op.cc:11-17).
    """
    if beam_branch.ndim == 2:
        return extract_best_beam_branch_kernel(
            best_final_branch, beam_branch, t_history
        )
    return jax.vmap(extract_best_beam_branch_kernel)(
        jnp.asarray(best_final_branch, jnp.int32), beam_branch, t_history
    )


def _order_single(final_branch, beam_branch):
    """Walk (T, W) parents from one final branch -> (T,) ordered ancestry
    (src/v2_util.rs:26-36)."""

    def step(current, branch_row):
        prev = branch_row[current]
        return prev, current

    _, ordered = jax.lax.scan(
        step, jnp.asarray(final_branch, jnp.int32),
        beam_branch.astype(jnp.int32), reverse=True,
    )
    return ordered


def order_beam_branch(final_branch, beam_branch, beam_width: int | None = None):
    """All-beam reorder (src/v2_util.rs:6-24): final_branch (B, W),
    beam_branch (B, T, W) -> ordered (B, W, T)."""
    per_beam = jax.vmap(_order_single, in_axes=(0, None))  # over W
    return jax.vmap(per_beam)(  # over B
        jnp.asarray(final_branch, jnp.int32), beam_branch.astype(jnp.int32)
    )
