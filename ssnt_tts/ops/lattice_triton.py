"""The SSNT lattice alpha and beta walks as Pallas kernels for the GPU
(Triton route).

The XLA form of the walks (ops/lattice.py) is a `lax.scan` of U steps over
(B, T) columns. At training shapes (B=32, T=80, U=400) a column holds a few
thousand cells, far too few to fill the card, so each XLA step costs its
launch and loop overhead rather than its arithmetic. Here one program owns
a block of `_BB` utterances and walks all U columns inside one launch,
keeping the current column in registers; the recursion is the XLA one op
for op (`lattice._logaddexp`, the same `NEG` sentinel, the same
per-example beta init at u == output_length - 1).

Pallas's Triton lowering has no register-level slice, pad or roll, so the
recursion's t-1 / t+1 shift is built from what it does lower: a reshape to
(..., T/2, 2), a split into even and odd lanes, a shift of one half by the
same construction, and a join back (log2 T levels). It moves values and
does no arithmetic, so it is exact. The inputs of column u+1 are loaded
while column u is computed, which hides the load latency behind the
recursion's dependency chain.

Loads and stores are masked at the batch and T edges, so callers pass
unpadded (U, B, T) arrays. Padded lanes compute garbage that never flows
into a valid lane: the forward shift only reads t-1, and the backward
shift's last valid lane is forced to `NEG` exactly as the XLA shift fills
it.

These kernels compile only for the GPU. `interpret=True` runs them in the
Pallas interpreter, which is how the CPU tests reach them; nothing selects
interpret mode implicitly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ssnt_tts.ops.lattice import NEG, _logaddexp, make_loss_core

_BB = 16  # utterances per program
_NUM_WARPS = 8


def _t_pad(T: int) -> int:
    return max(16, pl.next_power_of_2(T))


def _shift(x, up: bool):
    """x[..., t] -> x[..., t-1] (down) or x[..., t+1] (up) along the last
    axis, a power of two; the lane shifted in is 0."""
    n = x.shape[-1]
    if n == 1:
        return jnp.zeros_like(x)
    pairs = x.reshape(x.shape[:-1] + (n // 2, 2))
    even, odd = jnp.split(pairs, 2, axis=-1)
    even = even.reshape(x.shape[:-1] + (n // 2,))
    odd = odd.reshape(x.shape[:-1] + (n // 2,))
    if up:  # out[2k] = x[2k+1], out[2k+1] = x[2k+2]
        new_even, new_odd = odd, _shift(even, up)
    else:  # out[2k] = x[2k-1], out[2k+1] = x[2k]
        new_even, new_odd = _shift(odd, up), even
    return jnp.concatenate(
        [new_even[..., None], new_odd[..., None]], axis=-1
    ).reshape(x.shape)


def _col_io(b0, B, T, tp):
    rows = b0 + jax.lax.broadcasted_iota(jnp.int32, (_BB, tp), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (_BB, tp), 1)
    mask = (rows < B) & (cols < T)

    def load(ref, u):
        return plgpu.load(
            ref.at[u, pl.ds(b0, _BB), pl.ds(0, tp)], mask=mask, other=0.0
        )

    def store(ref, u, x):
        plgpu.store(ref.at[u, pl.ds(b0, _BB), pl.ds(0, tp)], x, mask=mask)

    return cols, load, store


def _alpha_kernel(le_ref, ls_ref, lf_ref, alpha_ref, *, tp):
    U, B, T = le_ref.shape
    b0 = pl.program_id(0) * _BB
    cols, load, store = _col_io(b0, B, T, tp)

    alpha = jnp.where(cols == 0, load(lf_ref, 0), NEG)
    store(alpha_ref, 0, alpha)

    def body(u, carry):
        alpha, le_prev, ls_prev, lf_u = carry
        nxt = (load(le_ref, u), load(ls_ref, u),
               load(lf_ref, jnp.minimum(u + 1, U - 1)))
        stay = alpha + le_prev
        moved = jnp.where(cols == 0, NEG, _shift(alpha + ls_prev, up=False))
        alpha = lf_u + _logaddexp(stay, moved)
        store(alpha_ref, u, alpha)
        return (alpha,) + nxt

    first = (load(le_ref, 0), load(ls_ref, 0), load(lf_ref, 1 % U))
    jax.lax.fori_loop(1, U, body, (alpha,) + first)


def _beta_kernel(il_ref, ol_ref, le_ref, ls_ref, lf_ref, beta_ref, *, tp):
    U, B, T = le_ref.shape
    b0 = pl.program_id(0) * _BB
    cols, load, store = _col_io(b0, B, T, tp)
    rmask = b0 + jnp.arange(_BB) < B
    il = plgpu.load(il_ref.at[pl.ds(b0, _BB)], mask=rmask, other=0)
    ol = plgpu.load(ol_ref.at[pl.ds(b0, _BB)], mask=rmask, other=0)
    is_last_t = cols == il[:, None] - 1
    u_init = ol[:, None] - 1

    def body(i, carry):
        # Column u = U-1-i; the carry holds column u+1's beta and lf (NEG
        # past the end, as the XLA scan's initial carry) and column u's
        # le and ls.
        beta_next, lf_next, le, ls = carry
        u = U - 1 - i
        prev = jnp.maximum(u - 1, 0)
        nxt = (load(lf_ref, u), load(le_ref, prev), load(ls_ref, prev))
        emit_cont = le + lf_next + beta_next
        moved = _shift(lf_next + beta_next, up=True)
        shift_cont = ls + jnp.where(cols == T - 1, NEG, moved)
        beta = jnp.where(
            u == u_init,
            jnp.where(is_last_t, le, NEG),
            _logaddexp(emit_cont, shift_cont),
        )
        store(beta_ref, u, beta)
        return (beta,) + nxt

    neg = jnp.full((_BB, tp), NEG, jnp.float32)
    first = (load(le_ref, U - 1), load(ls_ref, U - 1))
    jax.lax.fori_loop(0, U, body, (neg, neg) + first)


def _call(kernel, out_like, args, *, interpret: bool):
    U, B, T = out_like.shape
    return pl.pallas_call(
        functools.partial(kernel, tp=_t_pad(T)),
        out_shape=jax.ShapeDtypeStruct((U, B, T), jnp.float32),
        grid=(pl.cdiv(B, _BB),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(*args)


def forward_alphas(le, ls, lf, *, interpret: bool = False):
    """All alpha columns: (U, B, T) f32 inputs -> (U, B, T) alphas, equal
    to `lattice._forward_alphas`."""
    return _call(_alpha_kernel, le, (le, ls, lf), interpret=interpret)


def backward_betas(le, ls, lf, input_length, output_length, *,
                   interpret: bool = False):
    """All beta columns with the per-example init, equal to
    `lattice._backward_betas`."""
    return _call(
        _beta_kernel, le,
        (input_length, output_length, le, ls, lf),
        interpret=interpret,
    )


loss_core = make_loss_core(forward_alphas, backward_betas)
