"""Blocked parallel-scan SSNT lattice (latency-breaking formulation).

The column recursion
    alpha_u[t] = lse(M_u[t,0] + alpha_{u-1}[t], M_u[t,1] + alpha_{u-1}[t-1])
is linear over the (logaddexp, +) semiring with a 2-banded operator
    M_u[t,0] = lf[t,u] + le[t,u-1]      (stay)
    M_u[t,1] = lf[t,u] + ls[t-1,u-1]    (shift, from t-1)
so U sequential columns can be traded for:
  1. tree-composition of K consecutive operators into one (K+1)-banded
     block-transfer operator — embarrassingly parallel across blocks
     (trades ~K/2 extra FLOPs per cell for parallelism; the vector units have
     headroom over the latency-bound sequential walk),
  2. a boundary walk of only U/K sequential band-applies,
  3. interior recovery: every block replays its K columns from its boundary
     state simultaneously (blocks form a batch axis) — K sequential steps
     total for ALL interiors.
Sequential depth drops from U to U/K + K.

Ragged batches are uniformized instead of special-cased: for u >= U_b the
inputs are rewritten to the absorbing column (le=0, ls=NEG, lf=0), which
makes the *backward* recursion's per-example re-initialization emerge from a
single global init at the padded end — beta_{U_b-1} comes out exactly as
where(t == T_b-1, le[t, U_b-1], NEG) after identity propagation through the
padding. The forward needs no change (its init is global at u=0).

This module is pure XLA (the parallel phases are big fused elementwise maps;
the two short sequential phases are lax.scans). It is not dispatched: the
loss runs the Pallas walks on the GPU (ops/lattice_triton.py), which beat
it at B=32 and B=256 on the H100 (PERF.md). `chip_smoke.py` and
`bench.py` time it beside them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ssnt_tts.ops.lattice import (
    NEG,
    _canonicalize,
    _gather_logz,
    _logaddexp,
    _posterior_grads,
)


def _shift_t(x, k, fill=NEG):
    """x[..., t] -> x[..., t-k] along the last axis (first k entries fill)."""
    if k == 0:
        return x
    if k >= x.shape[-1]:
        return jnp.full(x.shape, fill, x.dtype)
    return jnp.concatenate(
        [jnp.full(x.shape[:-1] + (k,), fill, x.dtype), x[..., :-k]],
        axis=-1,
    )


def _uniformize(le, ls, lf, output_length):
    """(U, B, T) inputs -> absorbing-column padding for u >= U_b.

    ls is killed one column earlier (u >= U_b - 1): a shift at the final
    live frame is impossible (only the stop emit follows), and leaving the
    real ls there would open a spurious path into the absorbing region
    through beta_{U_b}'s t = T_b-1 entry."""
    U = le.shape[0]
    u_idx = jnp.arange(U)[:, None, None]
    out_len = output_length[None, :, None]
    live = u_idx < out_len
    le = jnp.where(live, le, 0.0)
    ls = jnp.where(u_idx < out_len - 1, ls, NEG)
    lf = jnp.where(live, lf, 0.0)
    return le, ls, lf


def _compose_v(Bop, A):
    """Same composition but with the band axis kept LAST and the T axis
    second-to-last: shapes (..., T, band)."""
    b2 = Bop.shape[-1]
    b1 = A.shape[-1]
    out_band = b1 + b2 - 1
    C = jnp.full(A.shape[:-1] + (out_band,), NEG, A.dtype)
    for k in range(b2):
        # A entries must be read at source row t-k: shift along T (-2 axis).
        A_shift = _shift_t(jnp.swapaxes(A, -1, -2), k)
        A_shift = jnp.swapaxes(A_shift, -1, -2)
        contrib = Bop[..., k : k + 1] + A_shift  # (..., T, b1)
        C = C.at[..., k : k + b1].set(
            _logaddexp(C[..., k : k + b1], contrib)
        )
    return C


def _build_block_operators(le, ls, lf, K: int):
    """(U, B, T) uniform inputs -> (nb, B, T, K+1) block-transfer operators
    and the per-column (nb, K, B, T, 2) operators (for interior replay)."""
    U, B, T = le.shape
    assert U >= 2, "blocked scan needs U >= 2"
    assert K >= 2 and (K & (K - 1)) == 0, "K must be a power of two"
    diag = lf[1:] + le[:-1]  # (U-1, B, T)
    sub = lf[1:] + _shift_t(ls[:-1], 1)  # from t-1
    ncols = U - 1
    nb = -(-ncols // K)
    pad = nb * K - ncols
    if pad:
        # Identity operators: diag 0, sub NEG.
        diag = jnp.concatenate(
            [diag, jnp.zeros((pad, B, T), diag.dtype)], axis=0
        )
        sub = jnp.concatenate(
            [sub, jnp.full((pad, B, T), NEG, sub.dtype)], axis=0
        )
    cols = jnp.stack([diag, sub], axis=-1)  # (nb*K, B, T, 2)
    per_col = cols.reshape(nb, K, B, T, 2)

    # Tree-combine along the K axis: band 2 -> 3 -> 5 -> ... -> K+1.
    P = per_col
    m = K
    while m > 1:
        A = P[:, 0::2]
        Bop = P[:, 1::2]
        P = _compose_v(Bop, A)
        m //= 2
    return P[:, 0], per_col  # (nb, B, T, K+1), (nb, K, B, T, 2)


def _apply_band(P, s):
    """s'[t] = lse_j P[..., t, j] + s[t-j]. P (..., T, band); s (..., T)."""
    band = P.shape[-1]
    terms = jnp.stack(
        [P[..., j] + _shift_t(s, j) for j in range(band)], axis=0
    )
    return jax.nn.logsumexp(terms, axis=0)


def forward_alphas_scan(le, ls, lf, *, K: int = 16):
    """(U, B, T) uniform inputs -> (U, B, T) alphas via blocked scan."""
    U, B, T = le.shape
    P, per_col = _build_block_operators(le, ls, lf, K)
    nb = P.shape[0]

    t0 = (jnp.arange(T) == 0)[None, :]
    alpha0 = jnp.where(t0, lf[0], NEG)  # (B, T)

    def boundary_step(s, P_i):
        s2 = _apply_band(P_i, s)
        return s2, s

    _, starts = jax.lax.scan(boundary_step, alpha0, P)  # (nb, B, T) block starts

    # Interior replay: all blocks advance together.
    def interior_step(s, col):
        # col: (nb, B, T, 2)
        s2 = _logaddexp(
            col[..., 0] + s, col[..., 1] + _shift_t(s, 1)
        )
        return s2, s2

    per_col_scan = jnp.moveaxis(per_col, 1, 0)  # (K, nb, B, T, 2)
    _, interiors = jax.lax.scan(interior_step, starts, per_col_scan)
    # interiors: (K, nb, B, T) = alpha at columns iK+1..iK+K.
    interiors = jnp.moveaxis(interiors, 0, 1).reshape(nb * K, B, T)
    alphas = jnp.concatenate([alpha0[None], interiors], axis=0)
    return alphas[:U]


def backward_betas_scan(le, ls, lf, input_length, *, K: int = 16):
    """(U, B, T) *uniformized* inputs -> (U, B, T) betas via blocked scan.

    With absorbing padding, one global init at the last padded column
    reproduces every example's true re-initialization (module docstring).
    Operator (superdiagonal): beta_u[t] = lse(N_u[t,0] + beta_{u+1}[t],
    N_u[t,1] + beta_{u+1}[t+1]) with
      N_u[t,0] = le[t,u] + lf[t,u+1]
      N_u[t,1] = ls[t,u] + lf[t+1,u+1].
    Implemented by flipping the T axis so the superdiagonal becomes a
    subdiagonal and reusing the forward machinery.
    """
    U, B, T = le.shape
    assert U >= 2, "blocked-scan beta needs U >= 2"
    t_idx = jnp.arange(T)[None, :]
    is_last_t = t_idx == input_length[:, None] - 1

    lf_next = lf[1:]  # (U-1, B, T): lf at u+1
    diag = le[:-1] + lf_next
    sup = ls[:-1] + _shift_up(lf_next)  # from t+1

    # Flip T so "from t+1" becomes "from t-1" (subdiagonal band form).
    diag_f = jnp.flip(diag, axis=-1)
    sup_f = jnp.flip(sup, axis=-1)
    # Reverse the u direction: operators applied from the end backwards.
    diag_f = jnp.flip(diag_f, axis=0)
    sup_f = jnp.flip(sup_f, axis=0)

    init = jnp.where(is_last_t, le[-1], NEG)  # beta at the last column
    init_f = jnp.flip(init, axis=-1)

    # Reuse the forward blocked scan on the flipped/reversed problem:
    # pseudo inputs whose (diag, sub) equal (diag_f, sup_f).
    ncols = U - 1
    nb = -(-ncols // K)
    pad = nb * K - ncols
    if pad:
        diag_f = jnp.concatenate(
            [diag_f, jnp.zeros((pad, B, T))], axis=0
        )
        sup_f = jnp.concatenate(
            [sup_f, jnp.full((pad, B, T), NEG)], axis=0
        )
    cols = jnp.stack([diag_f, sup_f], axis=-1)
    per_col = cols.reshape(nb, K, B, T, 2)
    P = per_col
    m = K
    while m > 1:
        P = _compose_v(P[:, 1::2], P[:, 0::2])
        m //= 2
    P = P[:, 0]

    def boundary_step(s, P_i):
        return _apply_band(P_i, s), s

    _, starts = jax.lax.scan(boundary_step, init_f, P)

    def interior_step(s, col):
        s2 = _logaddexp(col[..., 0] + s, col[..., 1] + _shift_t(s, 1))
        return s2, s2

    _, interiors = jax.lax.scan(
        interior_step, starts, jnp.moveaxis(per_col, 1, 0)
    )
    interiors = jnp.moveaxis(interiors, 0, 1).reshape(nb * K, B, T)
    betas_f = jnp.concatenate([init_f[None], interiors], axis=0)[:U]
    # Undo: u-order back (we walked from the end), T-flip back.
    betas = jnp.flip(jnp.flip(betas_f, axis=0), axis=-1)
    return betas


def _shift_up(x, fill=NEG):
    """x[..., t] -> x[..., t+1] (last entry fills)."""
    return jnp.concatenate(
        [x[..., 1:], jnp.full(x.shape[:-1] + (1,), fill, x.dtype)],
        axis=-1,
    )


# ---------------------------------------------------------------- full loss

@functools.partial(jax.custom_vjp, nondiff_argnums=(5,))
def _core(le, ls, lf, input_length, output_length, K):
    """Time-major core: (U, B, T) inputs, (U, B, T) grads."""
    loss, _ = _fwd(le, ls, lf, input_length, output_length, K)
    return loss


def _fwd(le, ls, lf, input_length, output_length, K):
    leu, lsu, lfu = _uniformize(le, ls, lf, output_length)
    alphas = forward_alphas_scan(leu, lsu, lfu, K=K)
    logz = _gather_logz(alphas, le, input_length, output_length)
    return -logz, (le, ls, lf, leu, lsu, lfu, alphas, logz, input_length,
                   output_length)


def _core_fwd(le, ls, lf, input_length, output_length, K):
    loss, res = _fwd(le, ls, lf, input_length, output_length, K)
    return loss, res


def _core_bwd(K, res, g):
    (le, ls, lf, leu, lsu, lfu, alphas, logz, input_length,
     output_length) = res
    betas = backward_betas_scan(leu, lsu, lfu, input_length, K=K)
    grads = _posterior_grads(le, ls, lf, alphas, betas, logz, input_length,
                             output_length, g)
    return grads + (None, None)


_core.defvjp(_core_fwd, _core_bwd)


def ssnt_loss_scan(log_emit, log_shift, log_frame=None, input_length=None,
                   output_length=None, *, K: int = 16, layout: str = "btu"):
    """Blocked-parallel-scan SSNT loss (same semantics/gradients as
    ops.lattice.ssnt_loss; values agree to f32 reassociation accuracy)."""
    args = _canonicalize(log_emit, log_shift, log_frame, input_length,
                         output_length, layout)
    if layout == "btu":
        args = (
            jnp.transpose(args[0], (2, 0, 1)),
            jnp.transpose(args[1], (2, 0, 1)),
            jnp.transpose(args[2], (2, 0, 1)),
        ) + args[3:]
    return _core(*args, K)
