"""Fully on-device batched beam-search decode loop.

The reference's decode loop lived in the absent model repo as a TF
while_loop that round-tripped through a CPU custom op every frame
(SURVEY.md §3.1). Here the whole decode — AR decoder step, joint scoring,
beam selection, history recording — is one `lax.scan` under jit: the beam
carry is a fixed-shape pytree, nothing leaves the device, and batches shard
over the mesh's data axis (beams stay chip-local, so decode needs no
collectives — SURVEY.md §5 long-context row).

Per step (mirroring the reference call stack, SURVEY.md §3.1-3.2):
  1. model.decode_step: h (B, W, 2) transition log-probs from (enc_t, GRU)
  2. ops.beam_v1.beam_search_step: expand/sort/dedup/pad (exact reference
     semantics)
  3. reorder per-beam AR state + predicted mel by parent_branch
  4. record (beam_branch, t_history, mel) for the post-loop backtrace

Each decoder's step is two public halves, `*_model_step` (1) and
`*_select_step` (2-4), over the carry that `*_carry0` builds, so a step can
also be driven from a given h (`chip_smoke.py` runs the selection on the
GPU from the CPU's h, step by step).

Post-loop: ops.backtrace.extract_best_beam_branch recovers the best path;
mel frames are gathered along it (the (B, U) alignment map the decoder
network attends with — the upsample op's role in the v2 pipeline).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp

from ssnt_tts.ops import (
    backtrace, beam_v1, beam_v2, tone_latent, upsample,
)


def beam_decode(
    model,
    params,
    tokens: jax.Array,
    input_length: jax.Array,
    *,
    max_frames: int,
    beam_width: int,
) -> Dict[str, jax.Array]:
    """Batched v1 beam decode.

    Args:
      model: SSNTModel (bound via apply).
      params: model variables.
      tokens: (B, T) i32.
      input_length: (B,) i32.
      max_frames: static max output frames (scan length).
      beam_width: static beam width W.

    Returns dict with:
      mel          (B, max_frames, M) best-path mel frames
      alignment    (B, max_frames) best-path source positions (t_history)
      beam_branch  (B, max_frames, W) parent pointers (for order_beam_branch)
      t_history    (B, max_frames, W)
      log_prob     (B, W) final cumulative log-probs (sorted desc)
      num_frames   (B,) frames generated by the best beam
    """
    B, T = tokens.shape
    W = beam_width
    cfg = model.config

    enc = model.apply(params, tokens, input_length, method=model.encode)

    def step(carry, _):
        h, model_out = v1_model_step(model, params, enc, carry)
        return v1_select_step(h, carry, model_out, input_length)

    carry0 = v1_carry0(B, W, cfg)
    (tF, uF, lpF, finF, _, _), (branches, t_hists, mels, preds) = jax.lax.scan(
        step, carry0, None, length=max_frames
    )
    return _v1_postprocess(branches, t_hists, mels, preds, lpF, uF)


def v1_carry0(B, W, config):
    """The v1 decode carry before the first step:
    (t, u, log_prob_history, is_finished, AR state, previous mel frame)."""
    return (
        jnp.zeros((B, W), jnp.int32),
        jnp.zeros((B, W), jnp.int32),
        jnp.zeros((B, W), jnp.float32),
        jnp.zeros((B, W), bool),
        jnp.zeros((B, W, config.decoder_dim), jnp.float32),
        jnp.zeros((B, W, config.mel_dim), jnp.float32),
    )


def v1_model_step(model, params, enc, carry):
    """The model half of one v1 decode step: the per-beam transition
    log-probs h (B, W, 2) and the model's new AR state and mel frame."""
    t, _, _, _, dec_state, prev_mel = carry
    h, new_state, mel = model.apply(
        params, enc, jnp.clip(t, 0, enc.shape[1] - 1), dec_state, prev_mel,
        method=model.decode_step,
    )
    return h, (new_state, mel)


def v1_select_step(h, carry, model_out, input_length):
    """The selection half of one v1 decode step: beam selection from h and
    the reorder of the model's per-beam state by parent pointers. Returns
    (new carry, per-step outputs)."""
    t, u, lp, fin, _, prev_mel = carry
    new_state, mel = model_out
    H = new_state.shape[-1]
    M = mel.shape[-1]
    (pred, lp2, nt, nu, nfin, branch) = beam_v1.beam_search_decode_batched(
        h, lp, fin, t, u, input_length
    )
    # Reorder per-beam state by parent pointers: one gather for all float
    # state and one for the int state.
    branch_i = branch[..., None].astype(jnp.int32)
    packed = jnp.concatenate([new_state, mel, prev_mel], axis=-1)
    packed = jnp.take_along_axis(packed, branch_i, axis=1)
    new_state, mel, prev_mel_g = (
        packed[..., :H], packed[..., H:H + M], packed[..., H + M:]
    )
    ints = jnp.stack([fin.astype(jnp.int32), t], axis=-1)
    ints = jnp.take_along_axis(ints, branch_i, axis=1)
    fin_prev = ints[..., 0].astype(bool)
    t_hist = ints[..., 1]  # frame's source pos
    # Finished beams emit no new frame; keep their last mel.
    mel = jnp.where(nfin[..., None] & fin_prev[..., None], prev_mel_g, mel)
    return (nt, nu, lp2, nfin, new_state, mel), (branch, t_hist, mel, pred)


def _v1_postprocess(branches, t_hists, mels, preds, lpF, uF):
    """v1 post-decode extraction: backtrace the best beam and gather its
    mel frames. Scan-stacked inputs: branches/t_hists/preds (U, B, W),
    mels (U, B, W, M)."""
    B = branches.shape[1]
    # scan stacks along axis 0: (U, B, W[, M]) -> (B, U, W[, M]).
    branches = jnp.moveaxis(branches, 0, 1)
    t_hists = jnp.moveaxis(t_hists, 0, 1)
    mels = jnp.moveaxis(mels, 0, 1)  # (B, U, W, M)

    # Beam 0 is the best hypothesis (beams are kept sorted desc every step).
    best_final = jnp.zeros((B,), jnp.int32)
    best_branch, best_t = backtrace.extract_best_beam_branch(
        best_final, branches, t_hists
    )  # (B, U) each
    best_mel = jnp.take_along_axis(
        mels, best_branch[..., None, None], axis=2
    )[:, :, 0, :]
    return {
        "mel": best_mel,
        "alignment": best_t,
        "beam_branch": branches,
        "t_history": t_hists,
        "prediction": jnp.moveaxis(preds, 0, 1),
        "log_prob": lpF,
        "num_frames": uF[:, 0],
    }


def greedy_decode(model, params, tokens, input_length, *, max_frames: int):
    """Greedy = beam width 1 (BASELINE.json configs[2])."""
    return beam_decode(
        model, params, tokens, input_length,
        max_frames=max_frames, beam_width=1,
    )


def _v2_postprocess(
    preds, branches, duration_table, input_length, max_frames,
    lpF, totF, finF, emptiedF,
):
    """Post-decode alignment extraction (SURVEY.md §3.3): all-beam
    backtrace, per-beam duration
    gathering, duration->frame upsampling. preds/branches: (T, B, W) as
    stacked by lax.scan."""
    duration_table = jnp.asarray(duration_table, jnp.int32)
    T = preds.shape[0]
    B, W = preds.shape[1], preds.shape[2]
    preds = jnp.moveaxis(preds, 0, 1)  # (B, T, W)
    branches = jnp.moveaxis(branches, 0, 1)  # (B, T, W)

    # All-beam backtrace (src/v2_util.rs:6-36): final branch of beam w is w.
    final_branch = jnp.broadcast_to(
        jnp.arange(W, dtype=jnp.int32)[None], (B, W)
    )
    ordered = backtrace.order_beam_branch(final_branch, branches)  # (B, W, T)

    # Gather each beam's predicted class along its ancestry, map to frames.
    pred_classes = jnp.take_along_axis(
        jnp.moveaxis(preds, 2, 1),  # (B, W, T) indexed by recording beam
        ordered,
        axis=1,
    )
    durations = duration_table[pred_classes]  # (B, W, T)
    # Zero out positions past each utterance's input length.
    tmask = jnp.arange(T)[None, None, :] < input_length[:, None, None]
    durations = jnp.where(tmask, durations, 0)
    beam_output_length = jnp.sum(durations, axis=-1)  # (B, W)

    source_indexes = upsample.upsample_source_indexes(
        durations, beam_output_length, -1, max_u=max_frames
    )  # (B, W, max_frames)
    return {
        "prediction": preds,
        "beam_branch": branches,
        "ordered_beam_branch": ordered,
        "durations": durations,
        "output_length": beam_output_length,
        "source_indexes": source_indexes,
        "log_prob": lpF,
        "total_duration": totF,
        "is_finished": finF,
        "beam_emptied": emptiedF,
    }


def v2_carry0(B, W, config):
    """The v2 decode carry before the first step: (log_prob_history,
    is_finished, total_duration, t, u, AR class state, previous class,
    beam ever emptied, prune counts and source t at the first emptying
    step)."""
    return (
        jnp.zeros((B, W), jnp.float32),
        jnp.zeros((B, W), bool),
        jnp.zeros((B, W), jnp.int32),
        jnp.zeros((B, W), jnp.int32),
        jnp.zeros((B, W), jnp.int32),
        jnp.zeros((B, W, config.decoder_dim), jnp.float32),
        jnp.zeros((B, W), jnp.int32),
        jnp.zeros((B,), bool),
        jnp.zeros((B, 4), jnp.int32),
        jnp.full((B,), -1, jnp.int32),
    )


def v2_model_step(model, params, enc, carry):
    """The model half of one v2 decode step: per-beam duration-class
    log-probs h (B, W, D) and the new AR class state."""
    _, _, _, t, _, dstate, prev_class, _, _, _ = carry
    return model.apply(params, enc, t, dstate, prev_class,
                       method=model.duration_decode_step)


def v2_select_step(
    h, carry, new_state, duration_table, input_length, output_length, *,
    zero_duration_id=0, allow_skip=False, test_mode=False,
    collect_diagnostics=False, config=None,
):
    """The selection half of one v2 decode step: the duration-class beam
    step from h and the reorder of the AR class state by parent pointers.
    Returns (new carry, per-step outputs)."""
    (lp, fin, tot, t, u, _, _, emptied, first_diag, first_t) = carry
    outs = beam_v2.beam_search_decode(
        h, lp, fin, tot, duration_table, t, u, input_length,
        output_length,
        zero_duration_id=zero_duration_id, allow_skip=allow_skip,
        test_mode=test_mode, return_num_survivors=True,
        config=config, return_diagnostics=collect_diagnostics,
    )
    if collect_diagnostics:
        (pred, lp2, nt, nu, nfin, ntot, branch, diag4, nsurv) = outs
    else:
        (pred, lp2, nt, nu, nfin, ntot, branch, nsurv) = outs
        diag4 = None
    # Reorder per-beam AR state by parent pointers; the new class
    # conditions the next step.
    new_state = jnp.take_along_axis(
        new_state, branch[..., None].astype(jnp.int32), axis=1
    )
    newly_empty = (nsurv == 0) & ~emptied
    if collect_diagnostics:
        # Record the prune attribution + source position of the FIRST
        # emptying step per utterance (VERDICT r3 #4 triage).
        first_diag = jnp.where(newly_empty[:, None], diag4, first_diag)
        first_t = jnp.where(newly_empty, t[:, 0], first_t)
    emptied = emptied | (nsurv == 0)
    return (
        lp2, nfin, ntot, nt, nu, new_state, pred, emptied,
        first_diag, first_t,
    ), (pred, branch)


def v2_duration_decode(
    model,
    params,
    tokens: jax.Array,
    input_length: jax.Array,
    output_length: jax.Array,
    duration_table,
    *,
    beam_width: int,
    max_frames: int,
    zero_duration_id: int = 0,
    allow_skip: bool = False,
    test_mode: bool = False,
    collect_diagnostics: bool = False,
    config=None,
) -> Dict[str, jax.Array]:
    """The reference's main production path (SURVEY.md §3.1 + §3.3), fully
    on-device: T steps of the v2 duration-class beam over **per-beam** h —
    each beam carries its own AR class state (GRU over its predicted class
    history), exactly the conditioning shape the reference op expects
    (h (B, W, D), ssnt_tts_v2_beam_search_decode_op.cc:29-50) — then all-beam
    backtrace (order_beam_branch), per-beam duration gathering, and
    duration->frame upsampling, the (B, W, U) text-position->mel-frame
    alignment map the decoder attends with.

    The reference round-tripped host<->device once per step through CPU ops;
    here the step loop is a lax.scan and the post-processing is the gather/
    cumsum ops from ops.backtrace/ops.upsample.

    Returns (among others) `beam_emptied (B,) bool`: True where some step
    produced zero surviving candidates — the condition under which the
    reference panics (src/v2.rs:292) — so callers can reject instead of
    silently consuming repeated-pad garbage (VERDICT r1 #4).
    """
    B, T = tokens.shape
    W = beam_width
    duration_table = jnp.asarray(duration_table, jnp.int32)

    enc = model.apply(params, tokens, input_length, method=model.encode)
    input_length = jnp.asarray(input_length, jnp.int32)
    output_length = jnp.asarray(output_length, jnp.int32)
    if test_mode:
        output_length = jnp.zeros_like(output_length)

    def step(carry, _):
        h, new_state = v2_model_step(model, params, enc, carry)
        return v2_select_step(
            h, carry, new_state, duration_table, input_length,
            output_length, zero_duration_id=zero_duration_id,
            allow_skip=allow_skip, test_mode=test_mode,
            collect_diagnostics=collect_diagnostics, config=config,
        )

    carry0 = v2_carry0(B, W, model.config)
    (
        (lpF, finF, totF, tF, uF, _, _, emptiedF, fdiagF, ftF),
        (preds, branches),
    ) = jax.lax.scan(step, carry0, None, length=T)
    out = _v2_postprocess(
        preds, branches, duration_table, input_length, max_frames,
        lpF, totF, finF, emptiedF,
    )
    if collect_diagnostics:
        # (B, 4) [band, overrun, exact_final, zero_skip] candidate counts
        # each constraint alone was blocking at the first emptying step,
        # and the source position where it happened (-1 = never emptied).
        out["first_empty_prune_counts"] = fdiagF
        out["first_empty_t"] = ftF
    return out


def tone_decode(
    model,
    params,
    tokens: jax.Array,
    input_length: jax.Array,
    *,
    beam_width: int,
    empty_tone_id: int = 0,
) -> Dict[str, jax.Array]:
    """Tone-latent beam decode over T source positions (SURVEY.md C3/C10)
    with per-beam AR conditioning (each beam's h reflects its own tone
    history, like the reference production path); evaluation pairs the output
    with ops.edit_distance (the reference's one eval metric)."""
    B, T = tokens.shape
    W = beam_width
    enc = model.apply(params, tokens, input_length, method=model.encode)
    input_length = jnp.asarray(input_length, jnp.int32)

    def step(carry, _):
        h, new_state = tone_model_step(model, params, enc, carry)
        return tone_select_step(
            h, carry, new_state, input_length, empty_tone_id=empty_tone_id
        )

    carry0 = tone_carry0(B, W, model.config)
    (lpF, finF, tF, uF, _, _), (preds, branches) = jax.lax.scan(
        step, carry0, None, length=T
    )
    return _tone_postprocess(
        preds, branches, input_length, empty_tone_id, lpF
    )


def tone_carry0(B, W, config):
    """The tone decode carry before the first step: (log_prob_history,
    is_finished, t, u, AR tone state, previous tone)."""
    return (
        jnp.zeros((B, W), jnp.float32),
        jnp.zeros((B, W), bool),
        jnp.zeros((B, W), jnp.int32),
        jnp.zeros((B, W), jnp.int32),
        jnp.zeros((B, W, config.decoder_dim), jnp.float32),
        jnp.zeros((B, W), jnp.int32),
    )


def tone_model_step(model, params, enc, carry):
    """The model half of one tone decode step: per-beam tone-class
    log-probs h (B, W, K) and the new AR tone state."""
    _, _, t, _, tstate, prev_class = carry
    return model.apply(params, enc, t, tstate, prev_class,
                       method=model.tone_decode_step)


def tone_select_step(h, carry, new_state, input_length, *,
                     empty_tone_id=0):
    """The selection half of one tone decode step: the tone-latent beam
    step from h and the reorder of the AR class state by parent pointers.
    Returns (new carry, per-step outputs)."""
    lp, fin, t, u, _, _ = carry
    (pred, lp2, nt, nu, nfin, branch) = tone_latent.beam_search_decode(
        h, lp, fin, t, u, input_length, empty_tone_id=empty_tone_id,
    )
    new_state = jnp.take_along_axis(
        new_state, branch[..., None].astype(jnp.int32), axis=1
    )
    return (lp2, nfin, nt, nu, new_state, pred), (pred, branch)


def _tone_postprocess(preds, branches, input_length, empty_tone_id, lpF):
    """Post-decode tone extraction. preds/branches: (T, B, W) as stacked by lax.scan."""
    T, B, W = preds.shape
    preds = jnp.moveaxis(preds, 0, 1)  # (B, T, W)
    branches = jnp.moveaxis(branches, 0, 1)
    final_branch = jnp.broadcast_to(
        jnp.arange(W, dtype=jnp.int32)[None], (B, W)
    )
    ordered = backtrace.order_beam_branch(final_branch, branches)
    tones = jnp.take_along_axis(jnp.moveaxis(preds, 2, 1), ordered, axis=1)
    tmask = jnp.arange(T)[None, None, :] < input_length[:, None, None]
    tones = jnp.where(tmask, tones, empty_tone_id)
    return {
        "tones": tones,  # (B, W, T)
        "prediction": preds,
        "beam_branch": branches,
        "log_prob": lpF,
    }
