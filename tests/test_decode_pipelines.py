"""v2 duration-decode and tone-decode production pipelines (SURVEY.md
§3.1/§3.3): on-device scan + all-beam backtrace + upsampling invariants."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ssnt_tts.models import SSNTModel
from ssnt_tts.oracle import numpy_oracle as pyo
from ssnt_tts.parallel import decode as decode_lib
from ssnt_tts.parallel import train as train_lib
from ssnt_tts.utils.config import TrainConfig, tiny_model_config

B, T, U = 2, 6, 20


@pytest.fixture(scope="module")
def model_and_params():
    cfg = tiny_model_config()
    model = SSNTModel(cfg)
    rng = np.random.default_rng(0)
    batch = {
        "tokens": jnp.asarray(
            rng.integers(1, cfg.vocab_size, (B, T)), jnp.int32
        ),
        "mel": jnp.asarray(rng.normal(0, 1, (B, U, cfg.mel_dim)),
                           jnp.float32),
        "input_length": jnp.asarray([T, T - 2], jnp.int32),
        "output_length": jnp.asarray([U, U - 6], jnp.int32),
    }
    state = train_lib.init_train_state(
        model, jax.random.PRNGKey(0), batch, TrainConfig(warmup_steps=2)
    )
    return model, state.params, batch


def test_v2_duration_decode_invariants(model_and_params):
    model, params, batch = model_and_params
    W = 4
    dur_table = np.array([0, 1, 2, 3, 4], np.int32)
    fn = jax.jit(
        lambda p, tok, il, ol: decode_lib.v2_duration_decode(
            model, p, tok, il, ol, dur_table,
            beam_width=W, max_frames=U, test_mode=True,
        )
    )
    out = fn(params, batch["tokens"], batch["input_length"],
             batch["output_length"])
    durs = np.asarray(out["durations"])
    ol = np.asarray(out["output_length"])
    src = np.asarray(out["source_indexes"])
    assert durs.shape == (B, W, T)
    assert set(np.unique(durs)) <= set(dur_table.tolist())
    np.testing.assert_array_equal(durs.sum(-1), ol)
    for b in range(B):
        Tb = int(batch["input_length"][b])
        assert (durs[b, :, Tb:] == 0).all()
        for w in range(W):
            n = ol[b, w]
            row = src[b, w]
            if n > 0:
                assert row[0] == 0 or durs[b, w, 0] == 0
                real = row[:n]
                assert ((np.diff(real) >= 0)).all()  # monotone
                assert (real < Tb).all() and (real >= 0).all()
            assert (row[n:] == -1).all()
    # Ordered ancestry must match the oracle backtrace of recorded branches.
    want = pyo.order_beam_branch(
        np.broadcast_to(np.arange(W, dtype=np.int32)[None], (B, W)),
        np.asarray(out["beam_branch"]),
    )
    np.testing.assert_array_equal(np.asarray(out["ordered_beam_branch"]),
                                  want)


def test_v2_duration_decode_constrained(model_and_params):
    """With constraints on (test_mode=False), surviving beams must sum to the
    requested output_length exactly (src/v2.rs:135-137)."""
    model, params, batch = model_and_params
    W = 4
    dur_table = np.array([0, 2, 3, 4, 5], np.int32)
    ol_req = jnp.asarray([18, 12], jnp.int32)
    fn = jax.jit(
        lambda p, tok, il, ol: decode_lib.v2_duration_decode(
            model, p, tok, il, ol, dur_table,
            beam_width=W, max_frames=U, allow_skip=True, test_mode=False,
        )
    )
    out = fn(params, batch["tokens"], batch["input_length"], ol_req)
    fin = np.asarray(out["is_finished"])
    tot = np.asarray(out["total_duration"])
    for b in range(B):
        for w in range(W):
            if fin[b, w]:
                assert tot[b, w] == int(ol_req[b]), (b, w, tot[b, w])


def test_v2_synthesis_from_alignment(model_and_params):
    """Full v2 synthesis: durations -> upsample -> AR mel generation."""
    model, params, batch = model_and_params
    W = 3
    dur_table = np.array([0, 1, 2, 3, 4], np.int32)

    def pipeline(p, tok, il, ol):
        out = decode_lib.v2_duration_decode(
            model, p, tok, il, ol, dur_table,
            beam_width=W, max_frames=U, test_mode=True,
        )
        enc = model.apply(p, tok, il, method=model.encode)
        best_src = out["source_indexes"][:, 0, :]  # (B, U)
        mel = model.apply(
            p, enc, best_src, method=model.synthesize_from_alignment
        )
        return mel, out["output_length"][:, 0]

    mel, olen = jax.jit(pipeline)(
        params, batch["tokens"], batch["input_length"],
        batch["output_length"],
    )
    mel = np.asarray(mel)
    assert mel.shape == (B, U, model.config.mel_dim)
    assert np.isfinite(mel).all()
    assert (np.asarray(olen) > 0).all()


def test_tone_decode_and_edit_distance_eval(model_and_params):
    from ssnt_tts.ops import edit_distance

    model, params, batch = model_and_params
    W, K = 3, model.config.tone_class_size
    fn = jax.jit(
        lambda p, tok, il: decode_lib.tone_decode(
            model, p, tok, il, beam_width=W, empty_tone_id=0
        )
    )
    out = fn(params, batch["tokens"], batch["input_length"])
    tones = np.asarray(out["tones"])
    assert tones.shape == (B, W, T)
    assert (tones >= 0).all() and (tones < K).all()
    # Eval loop: edit distance between best-beam tones and a reference.
    ref = np.asarray(batch["tokens"]) % K
    d = edit_distance.levenshtein_edit_distance(
        jnp.asarray(tones[:, 0, :]), jnp.asarray(ref.astype(np.int32)),
        batch["input_length"], batch["input_length"],
    )
    d = np.asarray(d)
    assert d.shape == (B,)
    assert (d >= 0).all() and (d <= np.asarray(batch["input_length"])).all()


def test_v2_per_beam_conditioning_diverges(model_and_params):
    """VERDICT r1 #2: beams must diverge through per-beam h (B, W, D) — the
    AR class state — not just constraint masks. With per-beam conditioning,
    different class histories produce different h rows."""
    model, params, batch = model_and_params
    # Direct check: duration_decode_step yields different rows for beams at
    # the same position with different class histories.
    enc = model.apply(params, batch["tokens"], batch["input_length"],
                      method=model.encode)
    W = 4
    Hs = model.config.decoder_dim
    beam_t = jnp.ones((B, W), jnp.int32)
    state = jnp.asarray(
        np.random.default_rng(1).normal(0, 1, (B, W, Hs)), jnp.float32
    )
    prev_class = jnp.asarray(
        np.arange(W)[None].repeat(B, 0) % model.config.duration_class_size,
        jnp.int32,
    )
    h, new_state = model.apply(
        params, enc, beam_t, state, prev_class,
        method=model.duration_decode_step,
    )
    h = np.asarray(h)
    assert h.shape == (B, W, model.config.duration_class_size)
    # Rows differ across beams (same position, different histories).
    assert not np.allclose(h[0, 0], h[0, 1])
    # And the full pipeline produces distinct per-beam log-probs.
    dur_table = np.array([0, 1, 2, 3, 4], np.int32)
    out = jax.jit(
        lambda p, tok, il, ol: decode_lib.v2_duration_decode(
            model, p, tok, il, ol, dur_table,
            beam_width=W, max_frames=U, test_mode=True,
        )
    )(params, batch["tokens"], batch["input_length"],
      batch["output_length"])
    lp = np.asarray(out["log_prob"])
    assert len(np.unique(lp[0])) > 1


def test_v2_beam_emptied_flag(model_and_params):
    """VERDICT r1 #4: an infeasible output_length must be *flagged* via
    beam_emptied (the reference would panic, src/v2.rs:292), not silently
    padded."""
    model, params, batch = model_and_params
    W = 4
    dur_table = np.array([0, 1, 2, 3, 4], np.int32)
    fn = jax.jit(
        lambda p, tok, il, ol: decode_lib.v2_duration_decode(
            model, p, tok, il, ol, dur_table,
            beam_width=W, max_frames=512, test_mode=False,
        )
    )
    # Feasible: 3 frames per source position (the overrun prune demands
    # U >= 3*(T-1), src/v2.rs:106-111).
    il = batch["input_length"]
    feas = fn(params, batch["tokens"], il, 3 * il)
    assert not np.asarray(feas["beam_emptied"]).any()
    # Infeasible: output_length far beyond max_duration * T — every class
    # falls outside the band/final-length constraints at some step.
    ol_bad = jnp.full((B,), 500, jnp.int32)
    bad = fn(params, batch["tokens"], il, ol_bad)
    assert np.asarray(bad["beam_emptied"]).all()


def test_tone_decode_per_beam_conditioning(model_and_params):
    """Tone pipeline threads per-beam AR state; beams expose distinct
    cumulative log-probs."""
    model, params, batch = model_and_params
    W = 4
    out = jax.jit(
        lambda p, tok, il: decode_lib.tone_decode(
            model, p, tok, il, beam_width=W,
        )
    )(params, batch["tokens"], batch["input_length"])
    lp = np.asarray(out["log_prob"])
    assert len(np.unique(lp[0])) > 1
    assert len(np.unique(lp[1])) > 1


def test_v2_empty_beam_diagnostics(model_and_params):
    """collect_diagnostics attributes the first emptying step to the prune
    that was binding (VERDICT r3 #4). An infeasible (huge) output_length
    dies on the diagonal band / exact-final constraints; a feasible one
    records nothing (first_empty_t == -1, counts 0)."""
    model, params, batch = model_and_params
    W = 4
    dur_table = np.array([0, 1, 2, 3, 4], np.int32)
    fn = jax.jit(
        lambda p, tok, il, ol: decode_lib.v2_duration_decode(
            model, p, tok, il, ol, dur_table,
            beam_width=W, max_frames=512, test_mode=False,
            collect_diagnostics=True,
        )
    )
    il = batch["input_length"]
    feas = fn(params, batch["tokens"], il, 3 * il)
    assert not np.asarray(feas["beam_emptied"]).any()
    assert (np.asarray(feas["first_empty_t"]) == -1).all()
    assert (np.asarray(feas["first_empty_prune_counts"]) == 0).all()

    bad = fn(params, batch["tokens"], il, jnp.full((B,), 500, jnp.int32))
    emptied = np.asarray(bad["beam_emptied"])
    assert emptied.all()
    ft = np.asarray(bad["first_empty_t"])
    counts = np.asarray(bad["first_empty_prune_counts"])  # (B, 4)
    assert (ft >= 0).all()
    # The binding constraint for an unreachably large output_length is the
    # diagonal band (total duration can never climb into the band window):
    # relaxing band alone must rescue candidates; and the diagnostics must
    # name at least one rescuer for every emptied utterance.
    assert (counts.sum(axis=1) > 0).all()
    assert (counts[:, 0] > 0).all()  # band is binding

    # Identical decode with diagnostics off returns the same beams.
    plain = jax.jit(
        lambda p, tok, il, ol: decode_lib.v2_duration_decode(
            model, p, tok, il, ol, dur_table,
            beam_width=W, max_frames=512, test_mode=False,
        )
    )(params, batch["tokens"], il, 3 * il)
    np.testing.assert_array_equal(
        np.asarray(plain["prediction"]), np.asarray(feas["prediction"])
    )


@pytest.mark.parametrize("decoder", ["v1", "v2", "tone"])
def test_step_halves_replay_the_decode_scan(model_and_params, decoder):
    """Driving a decoder's model half and selection half one step at a time
    from its initial carry gives the scan's per-step outputs bit for bit.
    Both run op by op (no jit), so both evaluate the same float ops."""
    with jax.disable_jit():
        _replay(model_and_params, decoder)


def _replay(model_and_params, decoder):
    model, params, batch = model_and_params
    cfg = model.config
    W = 4
    tok, il, ol = (batch[k] for k in
                   ("tokens", "input_length", "output_length"))
    table = np.asarray(cfg.duration_table, np.int32)
    enc = model.apply(params, tok, il, method=model.encode)
    if decoder == "v1":
        out = decode_lib.beam_decode(model, params, tok, il, max_frames=U,
                                     beam_width=W)
        carry0, model_step, n = decode_lib.v1_carry0, decode_lib.v1_model_step, U
        select = lambda h, c, mo: decode_lib.v1_select_step(h, c, mo, il)
        scan_out = (out["beam_branch"], out["prediction"])
        pick = lambda o: (o[0], o[3])  # (branch, pred)
    elif decoder == "v2":
        out = decode_lib.v2_duration_decode(model, params, tok, il, ol, table,
                                            beam_width=W, max_frames=U)
        carry0, model_step, n = decode_lib.v2_carry0, decode_lib.v2_model_step, T
        select = lambda h, c, mo: decode_lib.v2_select_step(
            h, c, mo, table, il, ol)
        scan_out = (out["beam_branch"], out["prediction"])
        pick = lambda o: (o[1], o[0])
    else:
        out = decode_lib.tone_decode(model, params, tok, il, beam_width=W)
        carry0, model_step, n = (decode_lib.tone_carry0,
                                 decode_lib.tone_model_step, T)
        select = lambda h, c, mo: decode_lib.tone_select_step(h, c, mo, il)
        scan_out = (out["beam_branch"], out["prediction"])
        pick = lambda o: (o[1], o[0])
    carry = carry0(B, W, cfg)
    branches, preds = [], []
    for _ in range(n):
        h, model_out = model_step(model, params, enc, carry)
        carry, step_out = select(h, carry, model_out)
        branch, pred = pick(step_out)
        branches.append(np.asarray(branch))
        preds.append(np.asarray(pred))
    np.testing.assert_array_equal(np.stack(branches, 1), scan_out[0])
    np.testing.assert_array_equal(np.stack(preds, 1), scan_out[1])
