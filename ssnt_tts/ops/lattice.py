"""SSNT forward-backward alignment-lattice losses.

The reference repo ships only the *decode* kernels; the training-side
forward-backward DP over the T x U alignment lattice (demanded by
BASELINE.json's north star and implied by the decode semantics in
/root/reference/src/lib.rs and /root/reference/src/v2.rs) lives here.

Lattice semantics are fixed by the decoder (src/lib.rs:172-230):

  Emit  : (t, u) -> (t, u+1)   stay on source frame t, output frame u+1
  Shift : (t, u) -> (t+1, u+1) advance source, output frame u+1
  Stop  : choosing Emit at t = T-1 terminates (src/lib.rs:187-195)

Because BOTH transitions advance u by exactly one, the lattice DP is
column-parallel: alpha[:, u] depends only on alpha[:, u-1]. The idiomatic
formulation is therefore a `lax.scan` over output frames u whose per-step body
is pure (B, T) vector math (one roll + one logaddexp) — no anti-diagonal
wavefront is needed at all. The same structure drives the Pallas walk
kernels in lattice_triton.py, which the loss dispatches to on the GPU.

Definitions (per batch element, lengths T=input_length, U=output_length):

  alpha[t, u] = log P(frames y_0..y_u generated, source position t at frame u)
              = log_frame[t, u]
                + logaddexp(alpha[t, u-1] + log_emit[t, u-1],
                            alpha[t-1, u-1] + log_shift[t-1, u-1])
  alpha[t, 0] = log_frame[t, 0] if t == 0 else -inf      (paths start at t=0)
  logZ        = alpha[T-1, U-1] + log_emit[T-1, U-1]     (final stop emit)
  loss        = -logZ

The analytic gradient uses the beta recursion
  beta[t, u]   = logaddexp(log_emit[t, u] + log_frame[t, u+1] + beta[t, u+1],
                           log_shift[t, u] + log_frame[t+1, u+1] + beta[t+1, u+1])
  beta[t, U-1] = log_emit[t, U-1] if t == T-1 else -inf
giving transition/occupancy posteriors:
  d(-logZ)/d log_emit[t, u]  = -exp(alpha + log_emit + cont_emit  - logZ)
  d(-logZ)/d log_shift[t, u] = -exp(alpha + log_shift + cont_shift - logZ)
  d(-logZ)/d log_frame[t, u] = -exp(alpha[t, u] + beta[t, u] - logZ)
wired in via jax.custom_vjp (verified against autodiff through the scan and
finite differences in tests/test_lattice.py).

Variable lengths are handled *inside* the scans: the beta scan re-initializes
its carry at u == U_b - 1 per batch element, so one fixed-length scan serves
ragged batches with zero host sync.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp

# Big-negative stand-in for log(0): avoids (-inf) - (-inf) NaNs in masked
# lattice regions while exp(NEG - x) still underflows to exactly 0.
NEG = -1e30


def _logaddexp(a, b):
    m = jnp.maximum(a, b)
    return m + jnp.log1p(jnp.exp(-jnp.abs(a - b)))


def _shift_down_t(x, fill=NEG):
    """x[..., t] -> x[..., t-1] along the last (T) axis; row 0 filled."""
    return jnp.concatenate(
        [jnp.full(x.shape[:-1] + (1,), fill, x.dtype), x[..., :-1]], axis=-1
    )


def _shift_up_t(x, fill=NEG):
    """x[..., t] -> x[..., t+1] along the last (T) axis; last row filled."""
    return jnp.concatenate(
        [x[..., 1:], jnp.full(x.shape[:-1] + (1,), fill, x.dtype)], axis=-1
    )


def _forward_alphas(log_emit_ubt, log_shift_ubt, log_frame_ubt):
    """All alpha columns. Inputs (U, B, T) -> alphas (U, B, T)."""
    U, B, T = log_emit_ubt.shape
    t_is_0 = (jnp.arange(T) == 0)[None, :]
    alpha0 = jnp.where(t_is_0, log_frame_ubt[0], NEG)

    def step(alpha, x):
        le_prev, ls_prev, lf = x
        stay = alpha + le_prev
        moved = _shift_down_t(alpha + ls_prev)
        alpha_new = lf + _logaddexp(stay, moved)
        return alpha_new, alpha_new

    _, alphas = jax.lax.scan(
        step,
        alpha0,
        (log_emit_ubt[:-1], log_shift_ubt[:-1], log_frame_ubt[1:]),
    )
    return jnp.concatenate([alpha0[None], alphas], axis=0)


def _backward_betas(log_emit_ubt, log_shift_ubt, log_frame_ubt,
                    input_length, output_length):
    """All beta columns with per-example length handling. (U, B, T) inputs."""
    U, B, T = log_emit_ubt.shape
    t_idx = jnp.arange(T)[None, :]
    is_last_t = t_idx == (input_length[:, None] - 1)  # (B, T)

    def step(beta_next, x):
        u, le, ls = x
        # Continuation columns are the *next* frame's values; gather them via
        # the scan over reversed u: x carries (u, log_emit[u], log_shift[u]),
        # beta_next / lf_next refer to column u+1 held in the carry.
        beta_col, lf_next = beta_next
        emit_cont = le + lf_next + beta_col
        shift_cont = ls + _shift_up_t(lf_next + beta_col)
        beta_rec = _logaddexp(emit_cont, shift_cont)
        # Per-example init at the true last output frame.
        init_col = jnp.where(is_last_t, le, NEG)
        beta_u = jnp.where((u == output_length[:, None] - 1), init_col,
                           beta_rec)
        lf_u = log_frame_ubt[u]
        return (beta_u, lf_u), beta_u

    u_range = jnp.arange(U)
    init = (jnp.full((B, T), NEG), jnp.full((B, T), NEG))
    _, betas = jax.lax.scan(
        step, init, (u_range, log_emit_ubt, log_shift_ubt), reverse=True
    )
    return betas  # (U, B, T)


def _gather_logz(alphas_ubt, log_emit_ubt, input_length, output_length):
    U, B, T = alphas_ubt.shape
    b_idx = jnp.arange(B)
    u_last = jnp.clip(output_length - 1, 0, U - 1)
    t_last = jnp.clip(input_length - 1, 0, T - 1)
    alpha_fin = alphas_ubt[u_last, b_idx, t_last]
    emit_fin = log_emit_ubt[u_last, b_idx, t_last]
    return alpha_fin + emit_fin


def _loss_impl(log_emit, log_shift, log_frame, input_length, output_length):
    """Plain (autodiff-able) loss used both directly and as the custom_vjp
    primal. Inputs (B, T, U); returns per-example loss (B,)."""
    le = jnp.transpose(log_emit, (2, 0, 1))
    ls = jnp.transpose(log_shift, (2, 0, 1))
    lf = jnp.transpose(log_frame, (2, 0, 1))
    alphas = _forward_alphas(le, ls, lf)
    logz = _gather_logz(alphas, le, input_length, output_length)
    return -logz


def ssnt_loss_reference(log_emit, log_shift, log_frame=None,
                        input_length=None, output_length=None):
    """Autodiff-through-scan variant (no custom_vjp) kept for verification."""
    log_emit, log_shift, log_frame, input_length, output_length = (
        _canonicalize(log_emit, log_shift, log_frame, input_length,
                      output_length)
    )
    return _loss_impl(log_emit, log_shift, log_frame, input_length,
                      output_length)


def _canonicalize(log_emit, log_shift, log_frame, input_length,
                  output_length, layout: str = "btu"):
    """Shared arg canonicalization to float32 lattices and int32 lengths.
    layout "btu": (B, T, U) inputs (the reference op layout); "ubt":
    time-major (U, B, T) native-kernel layout (no transposes anywhere in
    the loss path — the model's joints emit it directly)."""
    if layout == "btu":
        B, T, U = log_emit.shape
    elif layout == "ubt":
        U, B, T = log_emit.shape
    else:
        raise ValueError(f"unknown layout {layout!r}")
    if log_frame is None:
        log_frame = jnp.zeros_like(log_emit)
    if input_length is None:
        input_length = jnp.full((B,), T, jnp.int32)
    if output_length is None:
        output_length = jnp.full((B,), U, jnp.int32)
    return (
        log_emit.astype(jnp.float32),
        log_shift.astype(jnp.float32),
        log_frame.astype(jnp.float32),
        jnp.asarray(input_length, jnp.int32),
        jnp.asarray(output_length, jnp.int32),
    )


def _posterior_grads(le, ls, lf, alphas, betas, logz, input_length,
                     output_length, g):
    """Cotangents of the per-example NLL wrt (le, ls, lf), all (U, B, T),
    from the alpha and beta walks: one elementwise pass."""
    U, B, T = le.shape
    u_idx = jnp.arange(U)[:, None, None]
    t_idx = jnp.arange(T)[None, None, :]
    in_len = input_length[None, :, None]
    out_len = output_length[None, :, None]
    valid = (t_idx < in_len) & (u_idx < out_len)
    is_last_u = u_idx == out_len - 1
    is_last_t = t_idx == in_len - 1

    # Continuation values after each decision at (t, u):
    #   emit  -> frame u+1 at t      (or stop, if u==U-1 and t==T-1)
    #   shift -> frame u+1 at t+1
    lf_beta = lf + betas  # (U, B, T)
    lf_beta_next_u = jnp.concatenate(
        [lf_beta[1:], jnp.full((1, B, T), NEG)], axis=0
    )
    cont_emit = jnp.where(
        is_last_u, jnp.where(is_last_t, 0.0, NEG), lf_beta_next_u
    )
    cont_shift = jnp.where(is_last_u, NEG, _shift_up_t(lf_beta_next_u))

    logz_b = logz[None, :, None]
    degenerate = logz_b <= NEG / 2  # no valid path: zero grads

    def post(score):
        s = jnp.minimum(score - logz_b, 30.0)
        return jnp.where(valid & ~degenerate, jnp.exp(s), 0.0)

    emit_post = post(alphas + le + cont_emit)
    shift_post = post(alphas + ls + cont_shift)
    frame_post = post(alphas + betas)

    gB = g[None, :, None]  # upstream cotangent per example
    return -emit_post * gB, -shift_post * gB, -frame_post * gB


def make_loss_core(forward_alphas, backward_betas):
    """Time-major loss core over a pair of lattice walks: (U, B, T) inputs
    and (B,) lengths -> (B,) NLL, with the forward-backward gradient as a
    custom_vjp. The walks are `_forward_alphas`/`_backward_betas` or a
    kernel with the same contract. Layout adaptation (and its cotangent
    transposes) lives in the caller's autodiff, so ubt callers pay zero
    transposes."""

    @jax.custom_vjp
    def core(le, ls, lf, input_length, output_length):
        alphas = forward_alphas(le, ls, lf)
        return -_gather_logz(alphas, le, input_length, output_length)

    def fwd(le, ls, lf, input_length, output_length):
        alphas = forward_alphas(le, ls, lf)
        logz = _gather_logz(alphas, le, input_length, output_length)
        return -logz, (le, ls, lf, alphas, logz, input_length, output_length)

    def bwd(res, g):
        le, ls, lf, alphas, logz, input_length, output_length = res
        betas = backward_betas(le, ls, lf, input_length, output_length)
        grads = _posterior_grads(le, ls, lf, alphas, betas, logz,
                                 input_length, output_length, g)
        return grads + (None, None)

    core.defvjp(fwd, bwd)
    return core


xla_loss_core = make_loss_core(_forward_alphas, _backward_betas)


def dispatched_loss_core(le, ls, lf, input_length, output_length):
    """The loss core for the platform being compiled for: the Pallas walk
    kernels on CUDA GPUs, the XLA scans elsewhere. The choice is made when
    the computation is lowered (`lax.platform_dependent`), so work placed
    on the CPU of a GPU host gets the XLA scans. A kernel that fails to
    build raises; nothing falls back."""
    from ssnt_tts.ops import lattice_triton

    return jax.lax.platform_dependent(
        le, ls, lf, input_length, output_length,
        cuda=lattice_triton.loss_core, default=xla_loss_core,
    )


def ssnt_loss(log_emit, log_shift, log_frame=None, input_length=None,
              output_length=None, *, layout: str = "btu"):
    """SSNT emit/shift lattice negative log-likelihood.

    Args:
      log_emit, log_shift: (B, T, U) f32 transition log-probs at lattice
        point (t, u) (T source positions, U output frames). With
        layout="ubt", time-major (U, B, T) arrays instead — the framework's
        native layout (what the kernels consume; saves the 6 full-lattice
        HBM transpose passes per train step).
      log_frame: optional f32 log-likelihood of output frame u conditioned
        on source position t (e.g. Gaussian mel log-density), same layout.
        Defaults to zeros (pure alignment loss).
      input_length, output_length: optional (B,) i32 true lengths.
      layout: "btu" (reference op layout) or "ubt" (time-major native).

    Returns:
      (B,) f32 per-example negative log-likelihood, with analytic
      forward-backward gradients (custom_vjp).
    """
    args = _canonicalize(log_emit, log_shift, log_frame, input_length,
                         output_length, layout)
    if layout == "btu":
        args = (
            jnp.transpose(args[0], (2, 0, 1)),
            jnp.transpose(args[1], (2, 0, 1)),
            jnp.transpose(args[2], (2, 0, 1)),
        ) + args[3:]
    return dispatched_loss_core(*args)


# --------------------------------------------------------------------------
# v2: duration-class lattice (semi-Markov duration model)
# --------------------------------------------------------------------------

def ssnt_duration_loss(
    log_h,
    duration_table: Sequence[int],
    input_length=None,
    output_length=None,
    exclude_class: Optional[int] = None,
):
    """Duration-class lattice NLL matching the v2 decoder's alignment space.

    The v2 decoder (src/v2.rs) chooses one duration class per source position;
    class d contributes duration_table[d] output frames. The training DP sums
    over all class sequences whose durations total exactly output_length:

      alpha[t, u] = logsumexp_d alpha[t-1, u - dur[d]] + log_h[t-1, d]
      alpha[0, u] = 0 if u == 0 else -inf
      loss        = -alpha[T, U]

    A scan over source positions t with *static* duration shifts along the u
    axis (duration_table must be a static Python sequence) keeps every step a
    handful of (B, U+1) vector ops. Gradients flow via autodiff through the
    scan; the class posteriors it produces are the training signal for the v2
    duration predictor.

    Args:
      log_h: (B, T, D) f32 per-position duration-class log-probs.
      duration_table: static sequence of D non-negative ints.
      input_length, output_length: optional (B,) i32 true lengths.
      exclude_class: optionally bar one class id (the decoder's
        `zero_duration_id` when allow_skip=False, src/v2.rs:139,152).

    Returns:
      (B,) f32 per-example negative log-likelihood.
    """
    log_h = log_h.astype(jnp.float32)
    B, T, D = log_h.shape
    durations = tuple(int(d) for d in duration_table)
    if len(durations) != D:
        raise ValueError("duration_table length must match log_h class dim")
    if input_length is None:
        input_length = jnp.full((B,), T, jnp.int32)
    if output_length is None:
        raise ValueError("output_length is required for the duration lattice")
    input_length = jnp.asarray(input_length, jnp.int32)
    output_length = jnp.asarray(output_length, jnp.int32)
    Umax = int(max(durations)) * T

    u_size = Umax + 1
    alpha0 = jnp.where(
        jnp.arange(u_size)[None, :] == 0, 0.0, NEG
    ) * jnp.ones((B, 1))

    log_h_t = jnp.transpose(log_h, (1, 0, 2))  # (T, B, D)

    def step(alpha, lh):
        # alpha: (B, U+1); lh: (B, D)
        terms = []
        for d, dur in enumerate(durations):
            if exclude_class is not None and d == exclude_class:
                continue
            if dur == 0:
                shifted = alpha
            else:
                shifted = jnp.concatenate(
                    [jnp.full((B, dur), NEG), alpha[:, :-dur]], axis=1
                )
            terms.append(shifted + lh[:, d : d + 1])
        stacked = jnp.stack(terms, axis=0)
        m = jnp.max(stacked, axis=0)
        alpha_new = m + jnp.log(
            jnp.sum(jnp.exp(stacked - m[None]), axis=0)
        )
        alpha_new = jnp.maximum(alpha_new, NEG)  # keep masked cells bounded
        return alpha_new, alpha_new

    _, alphas = jax.lax.scan(step, alpha0, log_h_t)  # (T, B, U+1)
    alphas = jnp.concatenate([alpha0[None], alphas], axis=0)  # (T+1, B, U+1)

    b_idx = jnp.arange(B)
    t_fin = jnp.clip(input_length, 0, T)
    u_fin = jnp.clip(output_length, 0, Umax)
    logz = alphas[t_fin, b_idx, u_fin]
    return -logz
