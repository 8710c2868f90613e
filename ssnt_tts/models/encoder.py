"""Text encoder: embedding + conv prenet + transformer stack, and the
per-position class heads on top of it.

The reference repo contains no model code (SURVEY.md §0: the network lived
in the absent companion repo); this encoder feeds the lattice loss and the
decode steps with large fused matmuls, static shapes and bf16 compute.
Heads on top of the encoder supply exactly the per-position class
log-probs the reference decode ops consume:

  - duration logits -> h (B, T, D) for the v2 step (src/v2.rs h input)
  - tone logits     -> h (B, T, K) for the tone step (src/tone_latent.rs)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ssnt_tts.models import layers

_PRENET_LAYERS = 3
_PRENET_KERNEL = 5


def text_encoder_init(key, vocab_size: int, dim: int, num_layers: int):
    ke, kc, kb = jax.random.split(key, 3)
    return {
        "embed": layers.embed_init(ke, vocab_size, dim),
        "prenet": [
            {
                "conv": layers.conv1d_init(k, dim, _PRENET_KERNEL),
                "ln": layers.layer_norm_init(dim),
            }
            for k in jax.random.split(kc, _PRENET_LAYERS)
        ],
        "blocks": [
            layers.transformer_block_init(k, dim)
            for k in jax.random.split(kb, num_layers)
        ],
        "ln_f": layers.layer_norm_init(dim),
    }


def text_encoder(p, tokens, lengths, num_heads: int, dtype):
    """tokens (B, T) i32, lengths (B,) or None -> (B, T, dim) f32."""
    B, T = tokens.shape
    x = layers.embed(p["embed"], tokens, dtype)
    # Tacotron-style conv prenet over the token axis.
    for lp in p["prenet"]:
        x = jax.nn.relu(
            layers.layer_norm(lp["ln"], layers.conv1d(lp["conv"], x, dtype))
        )
    dim = x.shape[-1]
    x = x + layers.sinusoidal_positions(T, dim, dtype)[None]
    mask = None
    if lengths is not None:
        m = layers.length_mask(lengths, T)
        mask = m[:, None, None, :] & m[:, None, :, None]
    for bp in p["blocks"]:
        x = layers.transformer_block(bp, x, mask, num_heads, dtype)
    return layers.layer_norm(p["ln_f"], x)


def class_head_init(key, in_dim: int, hidden_dim: int, num_classes: int):
    """Per-position class head (duration or tone)."""
    k1, k2 = jax.random.split(key)
    return {
        "h1": layers.dense_init(k1, in_dim, hidden_dim),
        "out": layers.dense_init(k2, hidden_dim, num_classes),
    }


def class_head_logits(p, enc, dtype):
    """Pre-softmax scores, so the AR head can add its per-beam correction
    before normalization."""
    h = jax.nn.relu(layers.dense(p["h1"], enc, dtype))
    return layers.dense(p["out"], h, jnp.float32)


def ar_class_cell_init(key, num_classes: int, enc_dim: int, dim: int):
    """Per-beam autoregressive class state (GRU over embedded class
    history).

    The reference's v2/tone ops take per-beam `h (B, W, D)` recomputed by
    the caller from each beam's AR state every step
    (ssnt-tts-tensorflow/src/ssnt_tts_v2_beam_search_decode_op.cc:29-50);
    this cell is the model-side source of that state: beams diverge through
    their own class histories, not just through constraint masks."""
    ke, ki, kg, ko = jax.random.split(key, 4)
    return {
        "embed": layers.embed_init(ke, num_classes, dim),
        "enc_in": layers.dense_init(ki, enc_dim, dim),
        "gru": layers.gru_init(kg, dim, dim),
        "out": layers.dense_init(ko, dim, num_classes),
    }


def ar_class_cell_step(p, state, enc_t, prev_class, base_logits, dtype):
    """One AR step. state (..., H) f32; enc_t (..., Henc); prev_class (...,)
    i32; base_logits (..., D) from the per-position head.
    Returns (new_state, (..., D) log-probs)."""
    x = layers.embed(p["embed"], prev_class, dtype) + layers.dense(
        p["enc_in"], enc_t, dtype
    )
    new_state = layers.gru(p["gru"], state, x, dtype)
    logits = base_logits + layers.dense(p["out"], new_state, jnp.float32)
    return new_state, jax.nn.log_softmax(logits, axis=-1)
