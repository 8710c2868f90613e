"""Shared beam-selection machinery for the three SSNT beam-search step kernels.

The reference (Rust) implements each beam step as:

    expand candidates (ordered: beam-major, class-minor)
      -> stable sort descending by cumulative log-prob       (src/lib.rs:161)
      -> dedup consecutive candidates equal on all fields
         except parent_branch ("eq_ignore_parent")           (src/lib.rs:162)
      -> pad by repeating survivors from the front           (src/lib.rs:163-167)
      -> truncate to max_beam_width                          (src/lib.rs:168)

This module reproduces those semantics with fixed shapes on device: candidates
live in a dense (W*D,) layout (one slot per beam x class, with a validity
mask standing in for Rust's Option/filter_map).

Selection strategy (latency-shaped for the decode scan, VERDICT r2 #2):
entirely SORT-FREE, built from (C, C) pairwise matrices — bulk, fully
parallel vector work (C = W*D is at most a few hundred). Rust's dedup_by
removes a candidate iff it equals its immediate predecessor in the stable
sorted order (equality is transitive for non-NaN floats, so "equals the
last-retained element" collapses to adjacent equality — but ONLY adjacent:
an unequal interloper with the same log_prob between two equal candidates
preserves the later one). Both predicates come straight from ranks: each
valid candidate's sorted rank is a pairwise count (strictly-greater
log_prob, ties by generation index), candidate i is a duplicate iff some
equal candidate sits at rank(i) - 1, and each survivor's output slot is its
rank counted among survivors only. The output gather index is then an
integer one-hot reduction over the survivor-rank matches; the reference's
pad-by-repetition (results[i % n]) is index arithmetic on the wanted rank.
No sort, top_k, cumsum, or scatter anywhere.

Why not `lax.top_k` (what this replaced): besides being the one remaining
sorting primitive in the decode step, TopK on some backends orders floats
by a signed bit-pattern total order in which +0.0 sorts STRICTLY before
-0.0, whereas the reference's stable sort compares with IEEE `==` (−0.0
ties +0.0 and generation order decides). A finished beam carrying
log_prob −0.0 against an active +0.0 candidate therefore decoded
differently there than on CPU (where the conformance suites run). The pairwise ranks use IEEE compares,
so the sort-free form is reference-exact on every backend.

v2's diagonal re-injection (src/v2.rs:282-308) is supported via `diag_mask`:
the first surviving candidate flagged on-diagonal (= max log_prob, earliest
generation order among survivors — one argmax) replaces the final beam slot,
exactly like the reference's truncate(max_w-1) + push.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp


def select_beams(
    fields: Dict[str, jax.Array],
    valid: jax.Array,
    log_prob: jax.Array,
    max_beam_width: int,
    eq_keys: Sequence[str],
    diag_mask: Optional[jax.Array] = None,
    eq_packed: Optional[Sequence[jax.Array]] = None,
) -> Dict[str, jax.Array]:
    """Select the top `max_beam_width` beam hypotheses reference-identically.

    Args:
      fields: name -> (C,) candidate field arrays (C = beam_width * class_count).
        Candidate index order must match the reference's generation order
        (beam-major, class-minor); invalid slots may hold arbitrary values.
      valid: (C,) bool admissibility mask.
      log_prob: (C,) f32 cumulative log-probs (the sort key).
      max_beam_width: static output width.
      eq_keys: field names participating in `eq_ignore_parent` dedup
        (reference: prediction, log_prob, next_t, next_u, is_finished
        [, total_duration]).
      diag_mask: optional (C,) bool; if given, the first *surviving* candidate
        with a True flag replaces the last output slot (v2 diagonal
        re-injection, src/v2.rs:298-308).
      eq_packed: optional 1-2 (C,) int32 arrays: the eq_keys fields packed
        into injective integer keys by the caller (bounds documented at the
        call sites). When given they replace the per-field (C, C) compares —
        the pairwise matrices are the step's dominant byte traffic at
        C = W*D, so fewer compares is a direct HBM saving. log_prob is
        still compared separately (it is f32).

    Returns:
      name -> (max_beam_width,) selected fields, plus key "num_survivors"
      (scalar i32; 0 indicates the reference would have panicked with an
      empty beam, src/v2.rs:292).
    """
    C = valid.shape[0]
    gen = jnp.arange(C, dtype=jnp.int32)

    # Pairwise dedup (eq_ignore_parent, adjacency-exact). eq[i, j]: both
    # valid and equal on every eq field.
    eq = valid[:, None] & valid[None, :]
    eq &= log_prob[:, None] == log_prob[None, :]
    if eq_packed is not None:
        for a in eq_packed:
            eq &= a[:, None] == a[None, :]
    else:
        for k in eq_keys:
            if k == "log_prob":
                continue
            a = fields[k]
            eq &= a[:, None] == a[None, :]
    # Sorted rank among VALID candidates (invalid ones sort after all valid
    # ones and never dedup): before[i, j] = j precedes i in the stable
    # descending order.
    lp_i, lp_j = log_prob[:, None], log_prob[None, :]
    before = valid[None, :] & (
        (lp_j > lp_i) | ((lp_j == lp_i) & (gen[None, :] < gen[:, None]))
    )
    rank = jnp.sum(before, axis=1).astype(jnp.int32)  # (C,)
    # Duplicate iff the immediate sorted predecessor is field-equal.
    dup = jnp.any(eq & (rank[None, :] == rank[:, None] - 1), axis=1)
    keep = valid & ~dup
    n = jnp.sum(keep).astype(jnp.int32)

    # Rank among survivors = count of keep-predecessors in the same stable
    # order (no sort needed; unique per survivor since the order is total).
    krank = jnp.sum(before & keep[None, :], axis=1).astype(jnp.int32)

    # Output slot j wants survivor-rank j, with pad slots (j >= n) repeating
    # survivors from rank 0 (reference pushes results[i % n]). The gather
    # index is an exact integer one-hot reduction; if the beam emptied
    # (n == 0, where the reference panics — surfaced via num_survivors)
    # deterministically emit candidate 0.
    j = jnp.arange(max_beam_width, dtype=jnp.int32)
    n_safe = jnp.maximum(n, 1)
    want = jnp.where(j < n, j % n_safe, (j - n) % n_safe)
    hit = keep[None, :] & (krank[None, :] == want[:, None])  # (W_out, C)
    hit = hit | ((n == 0) & (gen[None, :] == 0))
    src = jnp.sum(hit * gen[None, :], axis=1)

    if diag_mask is not None:
        diag_keep = keep & diag_mask
        any_diag = jnp.any(diag_keep)
        # First survivor in sorted order with the flag = the flagged
        # candidate of minimal sorted rank (rank is unique among valid).
        # Folding the replacement into the gather index replaces one
        # .at-update per field with a single update on src.
        first = jnp.argmin(jnp.where(diag_keep, rank, C))
        last = max_beam_width - 1
        src = src.at[last].set(jnp.where(any_diag, first, src[last]))

    out = {k: v[src] for k, v in fields.items()}
    out["num_survivors"] = n
    return out


def interleave_candidates(per_class: Sequence[jax.Array]) -> jax.Array:
    """Stack per-class (W,) candidate arrays into beam-major (W*D,) order."""
    return jnp.stack(per_class, axis=1).reshape(-1)
