"""The plain-JAX model (float32, highest matmul precision) against the
independent NumPy float64 reference in oracle/model_reference.py."""

import jax
import numpy as np
import pytest

from ssnt_tts.models import SSNTModel
from ssnt_tts.oracle import model_reference as ref
from ssnt_tts.utils.config import tiny_model_config

B, T, U = 3, 7, 13
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_model_config(dtype="float32")
    model = SSNTModel(cfg)
    params = model.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    data = {
        "tokens": rng.integers(1, cfg.vocab_size, (B, T)).astype(np.int32),
        "mel": rng.normal(0, 1, (B, U, cfg.mel_dim)).astype(np.float32),
        "il": np.array([T, T - 2, 3], np.int32),
        "ol": np.array([U, U - 4, 9], np.int32),
    }
    return cfg, model, params, data


def _run(model, params, *args, method):
    with jax.default_matmul_precision("highest"):
        return jax.device_get(
            jax.jit(lambda p, *a: model.apply(p, *a, method=method))(
                params, *args))


def test_encoder(setup):
    cfg, model, params, d = setup
    got = _run(model, params, d["tokens"], d["il"], method=model.encode)
    want = ref.encode(params, cfg, d["tokens"], d["il"])
    np.testing.assert_allclose(got, want, **TOL)


def test_teacher_forced_decoder_states(setup):
    cfg, model, params, d = setup
    got = _run(model, params, d["mel"], method=model.decoder_states)
    np.testing.assert_allclose(got, ref.decoder_states(params, cfg, d["mel"]),
                               **TOL)


def test_lattice_quantities(setup):
    cfg, model, params, d = setup
    enc = ref.encode(params, cfg, d["tokens"], d["il"])
    dec = ref.decoder_states(params, cfg, d["mel"])
    got = _run(model, params, enc.astype(np.float32), dec.astype(np.float32),
               d["mel"], method=model.lattice_quantities)
    for g, w in zip(got, ref.lattice_quantities(params, cfg, enc, dec,
                                                d["mel"])):
        np.testing.assert_allclose(g, w, **TOL)


def test_training_nll(setup):
    cfg, model, params, d = setup
    got = _run(model, params, d["tokens"], d["mel"], d["il"], d["ol"],
               method=None)
    want = ref.nll(params, cfg, d["tokens"], d["mel"], d["il"], d["ol"])
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("head", ["duration_head", "tone_head"])
def test_class_heads(setup, head):
    cfg, model, params, d = setup
    method = (model.duration_log_probs if head == "duration_head"
              else model.tone_log_probs)
    got = _run(model, params, d["tokens"], d["il"], method=method)
    enc = ref.encode(params, cfg, d["tokens"], d["il"])
    np.testing.assert_allclose(got, ref.class_log_probs(params, head, enc),
                               **TOL)


def test_decode_step(setup):
    cfg, model, params, d = setup
    rng = np.random.default_rng(3)
    W = 4
    enc = ref.encode(params, cfg, d["tokens"], d["il"]).astype(np.float32)
    beam_t = rng.integers(0, T, (B, W)).astype(np.int32)
    state = rng.normal(0, 1, (B, W, cfg.decoder_dim)).astype(np.float32)
    prev = rng.normal(0, 1, (B, W, cfg.mel_dim)).astype(np.float32)
    got = _run(model, params, enc, beam_t, state, prev,
               method=model.decode_step)
    want = ref.decode_step(params, cfg, enc, beam_t, state, prev)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
