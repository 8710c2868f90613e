"""Batched Levenshtein edit distance (on-device).

Reference semantics: /root/reference/src/edit_distance.rs — Kaldi-style
two-row DP, batched over B, variable lengths via a_lengths/b_lengths.

Design: the inner row recurrence
    e_tmp[n] = min(e[n-1]+delta, e[n]+1, e_tmp[n-1]+1)
has a sequential dependency through e_tmp[n-1], but
    e_tmp[n] = min_k<=n (vals[k] + (n-k))  with vals[n] = min(e[n-1]+delta, e[n]+1)
which is n + running_min(vals[k]-k) — a prefix-min, fully vectorized per row.
The outer loop over rows is a lax.scan of length max_length with row masking
for variable a-lengths, and the whole thing vmaps over the batch. No O(L^2)
sequential chain remains.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_BIG = jnp.int32(1 << 28)


def levenshtein_edit_distance_kernel(a, b, a_length, b_length):
    """Edit distance between a[:a_length] and b[:b_length]; a, b: (L,) i32."""
    L = a.shape[0]
    n = jnp.arange(L + 1, dtype=jnp.int32)
    e0 = n  # E(0, n) = n

    def row(e, m):
        # vals[k] = min(E(m-1,k-1)+delta, E(m-1,k)+1) for k>=1; vals[0]=e[0]+1.
        delta = (a[m - 1] != b).astype(jnp.int32)  # (L,) vs b[n-1]
        term12 = jnp.minimum(e[:-1] + delta, e[1:] + 1)  # k = 1..L
        vals = jnp.concatenate([(e[0] + 1)[None], term12])
        shifted = jax.lax.cummin(vals - n)
        e_new = n + shifted
        e = jnp.where(m <= a_length, e_new, e)
        return e, None

    e, _ = jax.lax.scan(row, e0, jnp.arange(1, L + 1, dtype=jnp.int32))
    return e[b_length]


def levenshtein_edit_distance(a, b, a_lengths, b_lengths):
    """Batched edit distance, reference API parity
    (ssnt_tts_tensorflow/__init__.py:130-134). a, b: (B, L) i32;
    a_lengths, b_lengths: (B,) i32 -> (B,) i32 distances."""
    a = jnp.asarray(a, jnp.int32)
    b = jnp.asarray(b, jnp.int32)
    return jax.vmap(levenshtein_edit_distance_kernel)(
        a, b,
        jnp.asarray(a_lengths, jnp.int32),
        jnp.asarray(b_lengths, jnp.int32),
    )
