"""v2 duration-class monotonic beam-search step (on-device).

Reference semantics: /root/reference/src/v2.rs
  Each class d predicts `duration_table[d]` output frames for source position
  t. Hard admissibility constraints (all skipped in test_mode):
    - diagonal band: cumulative duration must stay within
      [trunc(max(diag - 0.05*U, 0)), trunc(min(diag + 0.1*U, U))] where
      diag = U/T * (t+1) in f32 (src/v2.rs:94-104, 131).
    - overrun prune: drop every class when (T-(t+1))*3 > U (src/v2.rs:106-111).
    - at the final source position, cumulative duration must equal U exactly
      (src/v2.rs:135-137) and the hypothesis finishes.
    - zero_duration_id is pruned unless allow_skip (src/v2.rs:139,152).
  Guaranteed-progress fallback: the first post-dedup candidate whose duration
  lies within [-20, 0] of the diagonal is re-injected into the last beam slot
  (src/v2.rs:282-308). A finished/out-of-range beam emits a single padding
  candidate (prediction=zero_duration_id, unchanged log-prob, finished)
  (src/v2.rs:313-323). Advance is (t,u)->(t+1,u+1) unless finished
  (src/v2.rs:330-331).

The reference panics when the beam empties (src/v2.rs:292); the JAX version
returns deterministic output plus a `num_survivors` count so callers can mask
or raise via checkify instead of aborting a whole slice.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .beam_common import select_beams
from ssnt_tts.utils.config import V2BeamConfig

# Reference defaults (src/v2.rs:96-116) — used when no config is passed.
_DEFAULT_CONFIG = V2BeamConfig()

_EQ_KEYS = (
    "prediction",
    "log_prob",
    "next_t",
    "next_u",
    "is_finished",
    "total_duration",
)


def _rounded(product, zero):
    """`product`, an f32 product, as its own rounded f32 value. The
    reference rounds every product before adding to it; XLA (on the CPU
    and the GPU) contracts a*b+c into one fused multiply-add with a single
    rounding, which moves values that sit exactly on a band edge or on the
    diagonal. Adding `zero` (an int32 that is 0 for every valid input but
    unknown to the compiler) to the product's bits keeps the multiply out
    of any sum."""
    bits = jax.lax.bitcast_convert_type(product, jnp.int32)
    return jax.lax.bitcast_convert_type(bits + zero, jnp.float32)


def beam_search_step(
    h: jax.Array,
    log_prob_history: jax.Array,
    is_finished: jax.Array,
    total_duration: jax.Array,
    duration_table: jax.Array,
    t: jax.Array,
    u: jax.Array,
    input_length: jax.Array,
    output_length: jax.Array,
    *,
    zero_duration_id: int,
    allow_skip: bool,
    test_mode: bool,
    max_beam_width: int | None = None,
    return_num_survivors: bool = False,
    return_diagnostics: bool = False,
    config: V2BeamConfig | None = None,
):
    """One v2 beam step for a single utterance.

    Args:
      h: (W, D) f32 per-beam duration-class log-probs.
      log_prob_history, is_finished, total_duration, t, u: (W,) beam state.
      duration_table: (D,) i32 frames-per-class.
      input_length, output_length: scalar i32 (T, U). In test_mode the
        reference zeroes output_length at the Python layer
        (ssnt_tts_tensorflow/__init__.py:47); the api wrapper does the same.
      zero_duration_id / allow_skip / test_mode: static attrs matching the TF
        op (ssnt_tts_v2_beam_search_decode_op.cc:39-43).
      config: V2BeamConfig supplying the band fractions, overrun multiplier
        and diagonal re-injection window. Defaults to the reference's
        hard-coded constants (src/v2.rs:96-116).

    Returns:
      (prediction, log_prob, next_t, next_u, next_is_finished,
       next_total_duration, beam_branch), each (max_beam_width,)
      [, num_survivors scalar i32 if return_num_survivors].
    """
    W, D = h.shape
    if D > 64:
        # The packed dedup key multiplies total_duration by 64 (eq-key
        # packing below); more classes would alias distinct hypotheses and
        # silently merge them. D is static, so fail loudly here (ADVICE r3).
        raise ValueError(
            f"duration_class_size {D} > 64 breaks eq-key packing injectivity"
        )
    if max_beam_width is None:
        max_beam_width = W
    cfg = config if config is not None else _DEFAULT_CONFIG

    t = t.astype(jnp.int32)
    u = u.astype(jnp.int32)
    total_duration = total_duration.astype(jnp.int32)
    duration_table = duration_table.astype(jnp.int32)
    T = jnp.asarray(input_length, jnp.int32)
    U = jnp.asarray(output_length, jnp.int32)
    hist = log_prob_history

    active = (t < T) & (~is_finished)  # src/v2.rs:119-125
    last = t == T - 1

    # Candidate grid (W, D): new cumulative duration per class.
    tot = total_duration[:, None] + duration_table[None, :]

    # Diagonal band in f32 with trunc-toward-zero casts (src/v2.rs:94-104).
    Uf = U.astype(jnp.float32)
    zero = jnp.minimum(U, 0)  # 0 for every valid length
    diag = _rounded(Uf / T.astype(jnp.float32)
                    * (t + 1).astype(jnp.float32), zero)  # (W,)
    low_off = _rounded(Uf * cfg.band_lower_frac, zero)
    up_off = _rounded(Uf * cfg.band_upper_frac, zero)
    lower = jnp.maximum(diag - low_off, 0.0).astype(jnp.int32)
    upper = jnp.minimum(diag + up_off, Uf).astype(jnp.int32)
    band_ok = (tot >= lower[:, None]) & (tot <= upper[:, None])

    # src/v2.rs:106-111
    overrun = (T - (t + 1)) * cfg.overrun_multiplier > U  # (W,)
    final_len_ok = (~last[:, None]) | (tot == U)
    class_ids = jnp.arange(D, dtype=jnp.int32)
    skip_ok = allow_skip | (class_ids != zero_duration_id)  # (D,)

    valid = active[:, None] & skip_ok[None, :]
    if not test_mode:
        valid = valid & band_ok & (~overrun)[:, None] & final_len_ok
        if cfg.final_feasible_guard:
            # Round-5 remedy (V2BeamConfig.final_feasible_guard): the
            # f = T-1-t future positions can only add [f*dmin, f*dmax]
            # frames, so candidates with U - tot outside that range can
            # never satisfy the exact-final rule — prune them now.
            adm = jnp.where(
                skip_ok, duration_table,
                jnp.iinfo(jnp.int32).max,
            )
            dmin = jnp.min(adm)
            dmax = jnp.max(duration_table)
            f = jnp.maximum(T - 1 - t, 0)[:, None]  # (W, 1)
            rem = U - tot
            valid = valid & (rem >= f * dmin) & (rem <= f * dmax)

    fin = jnp.broadcast_to(last[:, None], (W, D))
    pred = jnp.broadcast_to(class_ids[None, :], (W, D))
    lp = hist[:, None] + h
    nt = jnp.where(fin, t[:, None], t[:, None] + 1)
    nu = jnp.where(fin, u[:, None], u[:, None] + 1)
    parent = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[:, None], (W, D))

    # Padding candidate for finished/out-of-range beams occupies class slot 0
    # (the single item the reference emits, src/v2.rs:313-323); relative
    # beam-major candidate order is preserved.
    pad = ~active
    pad0 = pad[:, None] & (class_ids[None, :] == 0)
    pred = jnp.where(pad0, zero_duration_id, pred)
    lp = jnp.where(pad0, hist[:, None], lp)
    nt = jnp.where(pad0, t[:, None], nt)
    nu = jnp.where(pad0, u[:, None], nu)
    fin = jnp.where(pad0, True, fin)
    tot = jnp.where(pad0, total_duration[:, None], tot)
    valid = valid | pad0

    fields = {
        "prediction": pred.reshape(-1),
        "log_prob": lp.reshape(-1),
        "next_t": nt.reshape(-1),
        "next_u": nu.reshape(-1),
        "is_finished": fin.reshape(-1),
        "total_duration": tot.reshape(-1),
        "parent_branch": parent.reshape(-1),
    }

    diag_mask = None
    if not test_mode:
        # on_diagonal uses the *candidate's* next_t (src/v2.rs:113-117).
        diag_next = _rounded(
            Uf / T.astype(jnp.float32) * fields["next_t"].astype(jnp.float32),
            zero,
        )
        diff = fields["total_duration"].astype(jnp.float32) - diag_next
        lo, hi = cfg.diagonal_window
        diag_mask = (diff >= lo) & (diff <= hi)

    # The five int eq fields pack into TWO injective i32 keys, replacing
    # five (C, C) compares with two — the pairwise matrices dominate this
    # step's HBM traffic at C = W*D. Bounds (far above any TTS shape):
    # 0 <= next_u < 16384, |next_t| < 32768, total_duration < 2**17, D <= 64.
    ekey1 = fields["next_t"] * 16384 + fields["next_u"]
    ekey2 = (
        fields["total_duration"] * 64 + fields["prediction"]
    ) * 2 + fields["is_finished"].astype(jnp.int32)
    out = select_beams(
        fields,
        valid.reshape(-1),
        fields["log_prob"],
        max_beam_width,
        _EQ_KEYS,
        diag_mask=diag_mask,
        eq_packed=(ekey1, ekey2),
    )
    result = (
        out["prediction"],
        out["log_prob"],
        out["next_t"],
        out["next_u"],
        out["is_finished"],
        out["total_duration"],
        out["parent_branch"],
    )
    if return_diagnostics:
        # Prune attribution (VERDICT r3 #4, empty-beam triage): per
        # constraint, how many candidates of ACTIVE beams would survive if
        # exactly that one constraint were dropped. When a step empties
        # the beam (the reference's panic at src/v2.rs:292), these say
        # which prune was binding. Cheap one-hot sums; zero in test_mode
        # (no prunes active).
        act = active[:, None]
        no_ov = (~overrun)[:, None]
        sk = skip_ok[None, :]
        diags = jnp.stack(
            [
                jnp.sum((act & sk & no_ov & final_len_ok & ~band_ok)
                        .astype(jnp.int32)),
                jnp.sum((act & sk & band_ok & final_len_ok & ~no_ov)
                        .astype(jnp.int32)),
                jnp.sum((act & sk & band_ok & no_ov & ~final_len_ok)
                        .astype(jnp.int32)),
                jnp.sum((act & ~sk & band_ok & no_ov & final_len_ok)
                        .astype(jnp.int32)),
            ]
        )  # [band, overrun, exact_final, zero_skip]
        result = result + (diags,)
    if return_num_survivors:
        return result + (out["num_survivors"],)
    return result


def beam_search_decode(
    h,
    log_prob_history,
    is_finished,
    total_duration,
    duration_table,
    t,
    u,
    input_length,
    output_length,
    beam_width: int | None = None,
    duration_class_size: int | None = None,
    zero_duration_id: int = 0,
    allow_skip: bool = False,
    test_mode: bool = False,
    config: V2BeamConfig | None = None,
    return_num_survivors: bool = False,
    return_diagnostics: bool = False,
):
    """Batched v2 step, reference Python API parity
    (ssnt_tts_tensorflow/__init__.py:33-73).

    h: (B, W, D); beam state (B, W); duration_table (D,);
    input_length/output_length: (B,). In test_mode output_length is zeroed
    like the reference wrapper (__init__.py:47).

    return_diagnostics appends a (B, 4) i32 prune-attribution block
    [band, overrun, exact_final, zero_skip] (counts of active-beam
    candidates that each constraint alone is blocking) before the
    num_survivors output — the empty-beam triage instrumentation.
    """
    B, W, D = h.shape
    if beam_width is not None and beam_width != W:
        raise ValueError(f"beam_width {beam_width} != {W}")
    if duration_class_size is not None and duration_class_size != D:
        raise ValueError(f"duration_class_size {duration_class_size} != {D}")
    input_length = jnp.asarray(input_length, jnp.int32)
    output_length = jnp.asarray(output_length, jnp.int32)
    if test_mode:
        output_length = jnp.zeros_like(input_length)

    step = lambda h_, lph, fin, tot, t_, u_, il, ol: beam_search_step(
        h_, lph, fin, tot, duration_table, t_, u_, il, ol,
        zero_duration_id=zero_duration_id,
        allow_skip=allow_skip,
        test_mode=test_mode,
        config=config,
        return_num_survivors=return_num_survivors,
        return_diagnostics=return_diagnostics,
    )
    return jax.vmap(step)(
        h, log_prob_history, is_finished, total_duration, t, u,
        input_length, output_length,
    )
