"""Tone-latent (discrete prosody) beam-search step (on-device).

Reference semantics: /root/reference/src/tone_latent.rs — structurally the v2
step minus all duration bookkeeping: every tone class is admissible at every
step (tone_latent.rs:87-93), candidates never self-finish so the advance is
always (t,u)->(t+1,u+1) (tone_latent.rs:222-231), and finished/out-of-range
beams emit a single padding candidate carrying `empty_tone_id`
(tone_latent.rs:211-219). Sort/dedup/pad identical to v1/v2
(tone_latent.rs:194-205).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .beam_common import select_beams

_EQ_KEYS = ("prediction", "log_prob", "next_t", "next_u", "is_finished")


def beam_search_step(
    h: jax.Array,
    log_prob_history: jax.Array,
    is_finished: jax.Array,
    t: jax.Array,
    u: jax.Array,
    input_length: jax.Array,
    *,
    empty_tone_id: int,
    max_beam_width: int | None = None,
    return_num_survivors: bool = False,
):
    """One tone-latent beam step for a single utterance.

    h: (W, K) f32 per-beam tone-class log-probs; state (W,);
    input_length: scalar i32. Returns 6 arrays of shape (max_beam_width,)
    matching the TF op (tone_latent_beam_search_decode_op.cc:23-38).
    """
    W, K = h.shape
    # ekey2 below is prediction * 2 + finished; injectivity needs the
    # product to stay inside i32 (ADVICE r3 — static, so check loudly).
    if K * 2 >= 2**31:
        raise ValueError(f"tone_class_size {K} overflows eq-key packing")
    if max_beam_width is None:
        max_beam_width = W

    t = t.astype(jnp.int32)
    u = u.astype(jnp.int32)
    T = jnp.asarray(input_length, jnp.int32)
    hist = log_prob_history

    active = (t < T) & (~is_finished)  # tone_latent.rs:75-84
    class_ids = jnp.arange(K, dtype=jnp.int32)

    pred = jnp.broadcast_to(class_ids[None, :], (W, K))
    lp = hist[:, None] + h
    nt = jnp.broadcast_to(t[:, None] + 1, (W, K))
    nu = jnp.broadcast_to(u[:, None] + 1, (W, K))
    fin = jnp.zeros((W, K), bool)
    parent = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[:, None], (W, K))
    valid = jnp.broadcast_to(active[:, None], (W, K))

    # Padding candidate in class slot 0 for inactive beams.
    pad0 = (~active)[:, None] & (class_ids[None, :] == 0)
    pred = jnp.where(pad0, empty_tone_id, pred)
    lp = jnp.where(pad0, hist[:, None], lp)
    nt = jnp.where(pad0, t[:, None], nt)
    nu = jnp.where(pad0, u[:, None], nu)
    fin = jnp.where(pad0, True, fin)
    valid = valid | pad0

    fields = {
        "prediction": pred.reshape(-1),
        "log_prob": lp.reshape(-1),
        "next_t": nt.reshape(-1),
        "next_u": nu.reshape(-1),
        "is_finished": fin.reshape(-1),
        "parent_branch": parent.reshape(-1),
    }
    # Pack the four int eq fields into TWO injective i32 keys (bounds:
    # 0 <= next_u < 16384, 0 <= next_t < 16384, tone classes < 2**30);
    # see beam_common.select_beams eq_packed.
    ekey1 = fields["next_t"] * 16384 + fields["next_u"]
    ekey2 = fields["prediction"] * 2 + fields["is_finished"].astype(
        jnp.int32
    )
    out = select_beams(
        fields, valid.reshape(-1), fields["log_prob"], max_beam_width,
        _EQ_KEYS, eq_packed=(ekey1, ekey2),
    )
    result = (
        out["prediction"],
        out["log_prob"],
        out["next_t"],
        out["next_u"],
        out["is_finished"],
        out["parent_branch"],
    )
    if return_num_survivors:
        return result + (out["num_survivors"],)
    return result


def beam_search_decode(
    h,
    log_prob_history,
    is_finished,
    t,
    u,
    input_length,
    beam_width: int | None = None,
    tone_class_size: int | None = None,
    empty_tone_id: int = 0,
    return_num_survivors: bool = False,
):
    """Batched tone-latent step, reference Python API parity
    (ssnt_tts_tensorflow/__init__.py:99-127). h: (B, W, K); state (B, W);
    input_length (B,)."""
    B, W, K = h.shape
    if beam_width is not None and beam_width != W:
        raise ValueError(f"beam_width {beam_width} != {W}")
    if tone_class_size is not None and tone_class_size != K:
        raise ValueError(f"tone_class_size {tone_class_size} != {K}")
    step = lambda h_, lph, fin, t_, u_, il: beam_search_step(
        h_, lph, fin, t_, u_, il, empty_tone_id=empty_tone_id,
        return_num_survivors=return_num_survivors,
    )
    return jax.vmap(step)(
        h, log_prob_history, is_finished, t, u,
        jnp.asarray(input_length, jnp.int32),
    )
