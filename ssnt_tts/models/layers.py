"""Shared neural building blocks as plain JAX functions over parameter
dicts, bfloat16-friendly.

Every matmul-bearing layer takes `dtype`, the compute dtype (bfloat16 by
default), while parameters stay float32: the standard mixed-precision
recipe. Each layer is a pair: `<layer>_init(key, ...)` returns its
parameter dict, `<layer>(params, ...)` applies it.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

_lecun = jax.nn.initializers.lecun_normal()
_orthogonal = jax.nn.initializers.orthogonal()


def dense_init(key, d_in: int, d_out: int, *, bias: bool = True):
    p = {"kernel": _lecun(key, (d_in, d_out), jnp.float32)}
    if bias:
        p["bias"] = jnp.zeros((d_out,), jnp.float32)
    return p


def dense(p, x, dtype):
    """x @ kernel + bias, computed in `dtype`."""
    y = jnp.dot(x.astype(dtype), p["kernel"].astype(dtype))
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def embed_init(key, num: int, dim: int):
    return {
        "embedding": jax.random.normal(key, (num, dim), jnp.float32)
        / math.sqrt(dim)
    }


def embed(p, ids, dtype):
    return jnp.take(p["embedding"].astype(dtype), ids, axis=0)


def layer_norm_init(dim: int):
    return {
        "scale": jnp.ones((dim,), jnp.float32),
        "bias": jnp.zeros((dim,), jnp.float32),
    }


def layer_norm(p, x, eps: float = 1e-6):
    """LayerNorm over the last axis, computed in float32."""
    x = x.astype(jnp.float32)
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x - mean), axis=-1, keepdims=True)
    return (x - mean) * jax.lax.rsqrt(var + eps) * p["scale"] + p["bias"]


def gru_init(key, d_in: int, dim: int):
    """GRU cell with the three gates packed: input weights (d_in, 3H) with
    bias, recurrent weights (H, 3H) without, plus the candidate gate's
    recurrent bias."""
    ki, *kh = jax.random.split(key, 4)
    return {
        "wi": _lecun(ki, (d_in, 3 * dim), jnp.float32),
        "bi": jnp.zeros((3 * dim,), jnp.float32),
        "wh": jnp.concatenate(
            [_orthogonal(k, (dim, dim), jnp.float32) for k in kh], axis=1
        ),
        "bhn": jnp.zeros((dim,), jnp.float32),
    }


def gru(p, h, x, dtype):
    """One GRU step: (..., H) f32 state, (..., d_in) input -> new (..., H)
    f32 state (gates r, z, n in that order)."""
    gi = jnp.dot(x.astype(dtype), p["wi"].astype(dtype)) + p["bi"].astype(
        dtype
    )
    gh = jnp.dot(h.astype(dtype), p["wh"].astype(dtype))
    ir, iz, in_ = jnp.split(gi, 3, axis=-1)
    hr, hz, hn = jnp.split(gh, 3, axis=-1)
    r = jax.nn.sigmoid(ir + hr)
    z = jax.nn.sigmoid(iz + hz)
    n = jnp.tanh(in_ + r * (hn + p["bhn"].astype(dtype)))
    return (1.0 - z) * n + z * h


def attention_init(key, dim: int):
    kq, ko = jax.random.split(key)
    return {"qkv": dense_init(kq, dim, 3 * dim), "out": dense_init(ko, dim, dim)}


def attention(p, x, mask, num_heads: int, dtype):
    """Multi-head self-attention. x (B, T, D); mask (B, 1, T, T) bool or
    None (True = attend)."""
    B, T, D = x.shape
    hd = D // num_heads
    qkv = dense(p["qkv"], x, dtype).reshape(B, T, 3, num_heads, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    logits = jnp.einsum("bqhd,bkhd->bhqk", q / math.sqrt(hd), k)
    logits = logits.astype(jnp.float32)
    if mask is not None:
        logits = jnp.where(mask, logits, jnp.finfo(jnp.float32).min)
    w = jax.nn.softmax(logits, axis=-1).astype(dtype)
    y = jnp.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, D)
    return dense(p["out"], y, dtype)


def transformer_block_init(key, dim: int, hidden_mult: int = 4):
    ka, k1, k2 = jax.random.split(key, 3)
    return {
        "ln1": layer_norm_init(dim),
        "attn": attention_init(ka, dim),
        "ln2": layer_norm_init(dim),
        "ff1": dense_init(k1, dim, dim * hidden_mult),
        "ff2": dense_init(k2, dim * hidden_mult, dim),
    }


def transformer_block(p, x, mask, num_heads: int, dtype):
    """Pre-LN block; the residual stream stays float32."""
    y = attention(p["attn"], layer_norm(p["ln1"], x), mask, num_heads, dtype)
    x = x + y
    y = dense(p["ff1"], layer_norm(p["ln2"], x), dtype)
    y = dense(p["ff2"], jax.nn.gelu(y), dtype)
    return x + y


def conv1d_init(key, dim: int, kernel_size: int):
    return {
        "kernel": _lecun(key, (kernel_size, dim, dim), jnp.float32),
        "bias": jnp.zeros((dim,), jnp.float32),
    }


def conv1d(p, x, dtype):
    """'SAME'-padded 1D convolution over the T axis of (B, T, D)."""
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), p["kernel"].astype(dtype), window_strides=(1,),
        padding="SAME", dimension_numbers=("NWC", "WIO", "NWC"),
    )
    return y + p["bias"].astype(dtype)


def sinusoidal_positions(length: int, dim: int, dtype=jnp.float32):
    pos = jnp.arange(length)[:, None].astype(jnp.float32)
    div = jnp.exp(
        jnp.arange(0, dim, 2).astype(jnp.float32)
        * (-jnp.log(10000.0) / dim)
    )
    pe = jnp.zeros((length, dim))
    pe = pe.at[:, 0::2].set(jnp.sin(pos * div))
    pe = pe.at[:, 1::2].set(jnp.cos(pos * div))
    return pe.astype(dtype)


def length_mask(lengths: jax.Array, max_len: int) -> jax.Array:
    """(B,) lengths -> (B, max_len) bool mask."""
    return jnp.arange(max_len)[None, :] < lengths[:, None]
