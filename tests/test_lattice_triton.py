"""The Pallas (Triton) lattice walks in interpret mode against the XLA
walks, the XLA loss and the fp64 C++ oracle; the dispatch rule; and, on a
GPU only, the compiled kernels at training width."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssnt_tts.ops import lattice, lattice_triton

INTERPRET_CORE = lattice.make_loss_core(
    functools.partial(lattice_triton.forward_alphas, interpret=True),
    functools.partial(lattice_triton.backward_betas, interpret=True),
)


def _lattice(U, B, T, lengths, seed=0):
    rng = np.random.default_rng(seed)
    le = np.log(rng.uniform(0.1, 0.9, (U, B, T))).astype(np.float32)
    ls = np.log1p(-np.exp(le)).astype(np.float32)
    lf = rng.normal(0, 0.5, (U, B, T)).astype(np.float32)
    if lengths == "full":
        il = np.full(B, T, np.int32)
        ol = np.full(B, U, np.int32)
    elif lengths in ("ragged", "feasible"):
        il = rng.integers(1, T + 1, B).astype(np.int32)
        ol = rng.integers(1, U + 1, B).astype(np.int32)
        if lengths == "feasible":  # every utterance has a path
            ol = np.maximum(ol, il)
    else:  # degenerate: more tokens than frames, so no path exists
        il = np.full(B, T, np.int32)
        ol = np.full(B, max(T - 1, 1), np.int32)
    return tuple(jnp.asarray(x) for x in (le, ls, lf, il, ol))


# (U, B, T): batch not a multiple of the 16-row block, T not a power of
# two, single-column and single-token edges.
SHAPES = [(1, 3, 4), (2, 16, 1), (9, 17, 33), (23, 19, 11), (40, 5, 80),
          (12, 40, 7)]


@pytest.mark.parametrize("U,B,T", SHAPES)
@pytest.mark.parametrize("lengths", ["full", "ragged"])
def test_walks_equal_xla_walks(U, B, T, lengths):
    le, ls, lf, il, ol = _lattice(U, B, T, lengths)
    a = lattice_triton.forward_alphas(le, ls, lf, interpret=True)
    b = lattice_triton.backward_betas(le, ls, lf, il, ol, interpret=True)
    np.testing.assert_array_equal(
        np.asarray(a), np.asarray(lattice._forward_alphas(le, ls, lf)))
    np.testing.assert_array_equal(
        np.asarray(b),
        np.asarray(lattice._backward_betas(le, ls, lf, il, ol)))


@pytest.mark.parametrize("U,B,T,lengths", [
    (23, 19, 11, "ragged"), (40, 5, 80, "full"), (12, 40, 7, "ragged"),
    (6, 4, 8, "degenerate"),
])
def test_loss_and_grad_equal_xla(U, B, T, lengths):
    le, ls, lf, il, ol = _lattice(U, B, T, lengths, seed=1)

    def loss_and_grad(core):
        return jax.value_and_grad(
            lambda a, b, c: jnp.sum(core(a, b, c, il, ol)), argnums=(0, 1, 2)
        )(le, ls, lf)

    (v_k, g_k), (v_x, g_x) = (loss_and_grad(INTERPRET_CORE),
                              loss_and_grad(lattice.xla_loss_core))
    np.testing.assert_array_equal(np.asarray(v_k), np.asarray(v_x))
    for a, b in zip(g_k, g_x):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if lengths == "degenerate":
        assert all(not np.any(np.asarray(g)) for g in g_k)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grad_vs_cpp_oracle(seed):
    from ssnt_tts.oracle import build as cpp

    U, B, T = 40, 4, 12
    le, ls, lf, il, ol = _lattice(U, B, T, "feasible", seed=seed)
    loss, grads = jax.value_and_grad(
        lambda a, b, c: jnp.sum(INTERPRET_CORE(a, b, c, il, ol)),
        argnums=(0, 1, 2),
    )(le, ls, lf)
    per_ex = INTERPRET_CORE(le, ls, lf, il, ol)
    btu = [np.ascontiguousarray(np.transpose(np.asarray(x), (1, 2, 0)))
           for x in (le, ls, lf)]
    c_loss, *c_grads = cpp.ssnt_loss_grad(*btu, np.asarray(il),
                                          np.asarray(ol))
    np.testing.assert_allclose(np.asarray(per_ex), c_loss, rtol=2e-4,
                               atol=2e-4)
    for g, c in zip(grads, c_grads):
        np.testing.assert_allclose(np.transpose(np.asarray(g), (1, 2, 0)),
                                   c, rtol=2e-3, atol=2e-4)


def test_shift_is_exact_both_ways():
    x = jnp.arange(2 * 16, dtype=jnp.float32).reshape(2, 16) - 7.5
    np.testing.assert_array_equal(
        np.asarray(lattice_triton._shift(x, up=False)),
        np.concatenate([np.zeros((2, 1)), np.asarray(x)[:, :-1]], axis=1))
    np.testing.assert_array_equal(
        np.asarray(lattice_triton._shift(x, up=True)),
        np.concatenate([np.asarray(x)[:, 1:], np.zeros((2, 1))], axis=1))


def test_padded_lanes_do_not_leak():
    """Values past T and past B must not change any valid output."""
    le, ls, lf, il, ol = _lattice(10, 20, 12, "ragged", seed=3)
    a = lattice_triton.forward_alphas(le, ls, lf, interpret=True)
    wide = [jnp.concatenate([x, jnp.full(x.shape[:2] + (4,), 7.0)], axis=2)
            for x in (le, ls, lf)]
    a_wide = lattice_triton.forward_alphas(*wide, interpret=True)
    np.testing.assert_array_equal(np.asarray(a_wide)[:, :, :12],
                                  np.asarray(a))
    b = lattice_triton.backward_betas(le, ls, lf, il, ol, interpret=True)
    b_wide = lattice_triton.backward_betas(*wide, il, ol, interpret=True)
    # Betas are defined on each utterance's valid region (u < output
    # length, t < input length); the posteriors read nothing else.
    u = np.arange(10)[:, None, None]
    t = np.arange(12)[None, None, :]
    valid = (u < np.asarray(ol)[None, :, None]) & (
        t < np.asarray(il)[None, :, None])
    np.testing.assert_array_equal(np.asarray(b_wide)[:, :, :12][valid],
                                  np.asarray(b)[valid])


@pytest.mark.parametrize("platform", ["cuda", "cpu"])
def test_dispatch_by_platform(platform):
    """The dispatched loss lowers to the Triton kernels for CUDA and to the
    XLA scans (while loops) for the CPU, forward and backward."""
    le, ls, lf, il, ol = _lattice(6, 3, 5, "full")
    grad = jax.jit(jax.grad(lambda a: jnp.sum(lattice.ssnt_loss(
        a, ls, lf, il, ol, layout="ubt"))))
    text = grad.trace(le).lower(lowering_platforms=(platform,)).as_text()
    n_kernels = text.count("__gpu$xla.gpu.triton")
    if platform == "cuda":
        assert n_kernels == 2 and "stablehlo.while" not in text
    else:
        assert n_kernels == 0 and "stablehlo.while" in text


def test_kernel_never_interprets_unless_asked():
    """The dispatched kernel is traced with interpret=False, so off the GPU
    it fails to lower instead of silently running in the interpreter."""
    le, ls, lf, il, ol = _lattice(4, 3, 5, "full")

    def pallas_calls(jaxpr):
        for e in jaxpr.eqns:
            if e.primitive.name == "pallas_call":
                yield e
            for v in e.params.values():
                inner = getattr(v, "jaxpr", v)
                if hasattr(inner, "eqns"):
                    yield from pallas_calls(inner)

    jaxpr = jax.make_jaxpr(
        jax.grad(lambda a: jnp.sum(lattice_triton.loss_core(a, ls, lf, il,
                                                            ol)))
    )(le)
    calls = list(pallas_calls(jaxpr.jaxpr))
    assert len(calls) == 2  # the alpha walk and the beta walk
    assert all(not e.params["interpret"] for e in calls)
    with pytest.raises(Exception):
        jax.jit(lattice_triton.loss_core)(le, ls, lf, il, ol)


@pytest.mark.gpu
def test_compiled_kernels_at_training_width(gpu):
    le, ls, lf, il, ol = _lattice(400, 32, 80, "ragged", seed=4)
    a = jax.jit(lattice_triton.forward_alphas)(le, ls, lf)
    b = jax.jit(lattice_triton.backward_betas)(le, ls, lf, il, ol)
    np.testing.assert_array_equal(
        np.asarray(a), np.asarray(jax.jit(lattice._forward_alphas)(
            le, ls, lf)))
    np.testing.assert_array_equal(
        np.asarray(b), np.asarray(jax.jit(lattice._backward_betas)(
            le, ls, lf, il, ol)))
