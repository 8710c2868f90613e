"""Mel decoder + lattice joint network (factorized design).

The SSNT loss needs, for every lattice point (t, u):
  - transition log-probs log_emit/log_shift, time-major (U, B, T)
  - frame log-likelihood log p(y_u | t),     time-major (U, B, T)
(the layout the lattice walks consume; the joints emit it directly).

A naive additive-tanh joint materializes a (B, T, U, H) tensor. This module
instead uses factorizations whose lattice-sized intermediates are produced
directly by matmul contractions:

  transition logits:  logit_k[t, u] = <p_k(enc_t), q_k(dec_u)> + b_k(t) + b_k(u)
      -> one (B, T, 2R) x (B, U, 2R) batched matmul.
  frame likelihood:   mel_pred[t, u] = a(enc_t) + b(dec_u), isotropic Gaussian
      -> log p = -0.5/sig^2 * (||c_u||^2 - 2 a_t . c_u + ||a_t||^2) + const
         with c_u = y_u - b_u: ONE (B, T, M) x (B, U, M) matmul plus rank-1
         broadcasts; the (B, T, U, M) prediction tensor never exists.

Each joint has a full-lattice function (training) and a per-step function
(decode) over the same parameters, so beam decode scores are consistent
with the training loss.

The autoregressive state over mel frames is a GRU (teacher-forced scan
during training, stepped during decode).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ssnt_tts.models import layers


def ar_decoder_cell_init(key, mel_dim: int, dim: int):
    """Mel prenet (two ReLU layers) + GRU over generated mel frames; shared
    by training (scan over the teacher-forced sequence) and decode (stepped
    per output frame)."""
    k1, k2, kg = jax.random.split(key, 3)
    return {
        "prenet1": layers.dense_init(k1, mel_dim, dim),
        "prenet2": layers.dense_init(k2, dim, dim),
        "gru": layers.gru_init(kg, dim, dim),
    }


def ar_decoder_cell(p, carry, mel_frame, dtype):
    """(..., H) f32 carry, (..., M) frame -> new carry (also the output)."""
    x = jax.nn.relu(layers.dense(p["prenet1"], mel_frame, dtype))
    x = jax.nn.relu(layers.dense(p["prenet2"], x, dtype))
    return layers.gru(p["gru"], carry, x, dtype).astype(jnp.float32)


def transition_joint_init(key, enc_dim: int, dec_dim: int, rank: int):
    """Factorized emit/shift logits; rank R keeps the bilinear interaction
    matmul-shaped. Normalized per lattice point."""
    ke, kp, kd, kb, kc = jax.random.split(key, 5)
    return {
        "enc_proj": layers.dense_init(ke, enc_dim, 2 * rank),
        "dec_pre": layers.dense_init(kp, dec_dim, rank),
        "dec_proj": layers.dense_init(kd, rank, 2 * rank),
        "enc_bias": layers.dense_init(kb, enc_dim, 2),
        "dec_bias": layers.dense_init(kc, dec_dim, 2),
    }


def _transition_factors(p, enc, dec, dtype):
    f = layers.dense(p["enc_proj"], enc, dtype)  # (..., T, 2R)
    q = layers.dense(
        p["dec_proj"], jnp.tanh(layers.dense(p["dec_pre"], dec, dtype)), dtype
    )  # (..., U, 2R)
    return f, q


def transition_joint(p, enc, dec, dtype):
    """Full lattice, time-major: enc (B, T, H), dec (B, U, H) -> two
    (U, B, T) f32 log-prob arrays (log_emit, log_shift), emitted directly
    by the contraction (no full-lattice transpose ever exists)."""
    f, q = _transition_factors(p, enc, dec, dtype)
    B, T = f.shape[0], f.shape[1]
    U = q.shape[1]
    R = f.shape[-1] // 2
    logits = jnp.einsum(
        "btkr,bukr->ubtk", f.reshape(B, T, 2, R), q.reshape(B, U, 2, R),
        preferred_element_type=jnp.float32,
    )
    logits = (
        logits
        + layers.dense(p["enc_bias"], enc, jnp.float32)[None, :, :, :]
        + jnp.transpose(
            layers.dense(p["dec_bias"], dec, jnp.float32), (1, 0, 2)
        )[:, :, None, :]
    )
    le, ls = logits[..., 0], logits[..., 1]
    norm = jnp.logaddexp(le, ls)
    return le - norm, ls - norm


def transition_joint_step(p, enc_t, dec_state, dtype):
    """Per-step decode scores: enc_t (B, W, H) gathered at each beam's
    source position, dec_state (B, W, H) -> (B, W, 2) log-probs — the `h`
    input of the v1 beam step (src/lib.rs:19-29)."""
    f, q = _transition_factors(p, enc_t, dec_state, dtype)
    R = f.shape[-1] // 2
    f = f.reshape(*f.shape[:-1], 2, R)
    q = q.reshape(*q.shape[:-1], 2, R)
    logits = jnp.sum(f * q, axis=-1).astype(jnp.float32)
    logits = (
        logits
        + layers.dense(p["enc_bias"], enc_t, jnp.float32)
        + layers.dense(p["dec_bias"], dec_state, jnp.float32)
    )
    return jax.nn.log_softmax(logits, axis=-1)


def frame_joint_init(key, enc_dim: int, dec_dim: int, mel_dim: int):
    """Isotropic-Gaussian frame likelihood: mean a(enc_t) + b(dec_u)."""
    ke, kd = jax.random.split(key)
    return {
        "enc_mel": layers.dense_init(ke, enc_dim, mel_dim),
        "dec_mel": layers.dense_init(kd, dec_dim, mel_dim),
        "log_sigma": jnp.zeros((), jnp.float32),
    }


def frame_joint(p, enc, dec, mel_target, dtype):
    """Full lattice, time-major: -> (U, B, T) f32 log-likelihoods."""
    a = layers.dense(p["enc_mel"], enc, dtype).astype(jnp.float32)
    b = layers.dense(p["dec_mel"], dec, dtype).astype(jnp.float32)
    M = a.shape[-1]
    c = mel_target.astype(jnp.float32) - b
    inv_var = jnp.exp(-2.0 * p["log_sigma"])
    cross = jnp.einsum(
        "btm,bum->ubt", a, c, preferred_element_type=jnp.float32
    )
    sq_c = jnp.transpose(jnp.sum(c * c, axis=-1))  # (U, B)
    sq_a = jnp.sum(a * a, axis=-1)  # (B, T)
    sq_err = sq_c[:, :, None] - 2.0 * cross + sq_a[None, :, :]
    const = -0.5 * M * (jnp.log(2.0 * jnp.pi) + 2.0 * p["log_sigma"])
    return -0.5 * inv_var * sq_err + const


def frame_joint_predict(p, enc_t, dec_state, dtype):
    """Decode-time mel frame: (B, W, H) x2 -> (B, W, M)."""
    a = layers.dense(p["enc_mel"], enc_t, dtype)
    b = layers.dense(p["dec_mel"], dec_state, dtype)
    return (a + b).astype(jnp.float32)
