"""v1 SSNT emit/shift monotonic beam-search step (on-device).

Reference semantics: /root/reference/src/lib.rs
  - Transition classes: Emit=0 ((t,u)->(t,u+1)), Shift=1 ((t,u)->(t+1,u+1))
    (src/lib.rs:12-16, 206-226).
  - Emit at the last source frame finishes the hypothesis (src/lib.rs:187-195).
  - Shift at the last source frame is prohibited and converted to a finishing
    no-op that does NOT add the step log-prob (src/lib.rs:196-205).
  - A finished or out-of-range beam yields a single padding candidate
    (prediction=Emit, log_prob unchanged, finished) (src/lib.rs:174-184).
  - Candidates are sorted/deduped/padded per beam_common.select_beams
    (src/lib.rs:160-169).

The on-device design replaces the reference's per-beam heap allocation + rayon with
a dense (W, 2) candidate block and masked fixed-shape selection, so the whole
step jits into one fused XLA computation and batches via vmap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .beam_common import interleave_candidates, select_beams

EMIT = 0
SHIFT = 1

_EQ_KEYS = ("prediction", "log_prob", "next_t", "next_u", "is_finished")


def beam_search_step(
    h: jax.Array,
    log_prob_history: jax.Array,
    is_finished: jax.Array,
    t: jax.Array,
    u: jax.Array,
    input_length: jax.Array,
    *,
    max_beam_width: int | None = None,
):
    """One v1 beam step for a single utterance.

    Args:
      h: (W, 2) f32 per-beam transition log-probs [emit, shift].
      log_prob_history: (W,) f32 cumulative log-probs.
      is_finished: (W,) bool.
      t, u: (W,) i32 lattice positions.
      input_length: scalar i32 number of source frames (reference `max_t`).
      max_beam_width: static output width; defaults to W (the C ABI always
        passes beam_width, ssnt_tts_c/src/lib.rs:81-82).

    Returns:
      (prediction, log_prob, next_t, next_u, next_is_finished, beam_branch),
      each (max_beam_width,), matching the TF op outputs
      (ssnt_tts_beam_search_decode_op.cc:88-114).
    """
    W = h.shape[0]
    if max_beam_width is None:
        max_beam_width = W

    t = t.astype(jnp.int32)
    u = u.astype(jnp.int32)
    input_length = jnp.asarray(input_length, jnp.int32)

    active = (t >= 0) & (t < input_length) & (~is_finished)
    last = t == input_length - 1
    hist = log_prob_history

    # Emit slot: padding candidate when inactive (no log-prob added);
    # finishing emit at the last frame; ordinary emit otherwise.
    emit_pred = jnp.zeros((W,), jnp.int32)
    emit_lp = jnp.where(active, hist + h[:, EMIT], hist)
    emit_fin = ~(active & ~last)
    emit_nt = t
    emit_nu = jnp.where(active & ~last, u + 1, u)
    emit_valid = jnp.ones((W,), bool)

    # Shift slot: prohibited at the last frame -> converted to a finishing
    # Emit with unchanged log-prob; ordinary shift otherwise. Inactive beams
    # contribute no shift candidate.
    shift_pred = jnp.where(last, EMIT, SHIFT).astype(jnp.int32)
    shift_lp = jnp.where(last, hist, hist + h[:, SHIFT])
    shift_fin = last
    shift_nt = jnp.where(last, t, t + 1)
    shift_nu = jnp.where(last, u, u + 1)
    shift_valid = active

    parent = jnp.arange(W, dtype=jnp.int32)
    fields = {
        "prediction": interleave_candidates([emit_pred, shift_pred]),
        "log_prob": interleave_candidates([emit_lp, shift_lp]),
        "next_t": interleave_candidates([emit_nt, shift_nt]),
        "next_u": interleave_candidates([emit_nu, shift_nu]),
        "is_finished": interleave_candidates([emit_fin, shift_fin]),
        "parent_branch": interleave_candidates([parent, parent]),
    }
    valid = interleave_candidates([emit_valid, shift_valid])

    # Pack the four int eq fields into ONE injective i32 key. Injectivity
    # needs 0 <= next_u < 16384 plus |key| within i32; next_t itself may
    # legitimately be NEGATIVE (inactive padding candidates carry the
    # caller's t through unchanged) — the packing stays injective for
    # signed next_t, same as the v2 comment's phrasing. See
    # beam_common.select_beams eq_packed.
    ekey = (
        (fields["next_t"] * 16384 + fields["next_u"]) * 2
        + fields["prediction"]
    ) * 2 + fields["is_finished"].astype(jnp.int32)
    out = select_beams(
        fields, valid, fields["log_prob"], max_beam_width, _EQ_KEYS,
        eq_packed=(ekey,),
    )
    return (
        out["prediction"],
        out["log_prob"],
        out["next_t"],
        out["next_u"],
        out["is_finished"],
        out["parent_branch"],
    )


def beam_search_decode(
    h,
    log_prob_history,
    is_finished,
    t,
    u,
    max_t,
    beam_width: int | None = None,
):
    """Reference-parity unbatched wrapper (ssnt_tts_tensorflow/__init__.py:8-21).

    `beam_width` is accepted for API parity; shapes are static in JAX so it is
    validated rather than used.
    """
    if beam_width is not None and h.shape[0] != beam_width:
        raise ValueError(f"beam_width {beam_width} != h.shape[0] {h.shape[0]}")
    return beam_search_step(h, log_prob_history, is_finished, t, u, max_t)


def beam_search_decode_batched(
    h, log_prob_history, is_finished, t, u, input_length, *, max_beam_width=None
):
    """Batched v1 step: h (B, W, 2), state (B, W), input_length (B,).

    Mirrors the batched Rust core (src/lib.rs:121-147) which the C ABI only
    ever calls with batch_size=1 (ssnt_tts_c/src/lib.rs:13); the JAX version
    makes the batch axis first-class via vmap.
    """
    step = lambda *a: beam_search_step(*a, max_beam_width=max_beam_width)
    return jax.vmap(step)(h, log_prob_history, is_finished, t, u, input_length)
