"""Randomized batched beam-step cases checked bit for bit against the numpy
oracle.

The grid covers what exact selection has to get right and what plain
randomized cases rarely reach: candidate sets wider than 128 (C = W x
classes), -0.0/+0.0 and exact log-prob ties, batches that mix finished,
out-of-range and live beams (with widening for v1), and v2 candidates
that land exactly on a diagonal whose f32 value is rounded (U not a
multiple of T), where a fused multiply-add would move them off it. The CPU
tests run every case (`tests/test_beam_grid.py`); `chip_smoke.py` runs the
same cases on the GPU, where the same XLA step is compiled by another
backend.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import jax
import numpy as np

from ssnt_tts.oracle import numpy_oracle as oracle
from ssnt_tts.ops import beam_v1, beam_v2, tone_latent

KINDS = ("v1", "v2", "tone")
VARIANTS = ("wide", "ties", "finished", "diagonal")
SEEDS = (0, 1)
# (beam width, classes) per kind and variant; "wide" makes C > 128.
_SHAPES = {
    "v1": {"wide": (72, 2), "ties": (8, 2), "finished": (6, 2)},
    "v2": {"wide": (16, 10), "ties": (8, 6), "finished": (6, 5),
           "diagonal": (8, 6)},
    "tone": {"wide": (20, 8), "ties": (6, 5), "finished": (5, 4)},
}
_B = 8
_NAMES = ["prediction", "log_prob", "next_t", "next_u", "is_finished",
          "beam_branch"]


def cases() -> List[Tuple[str, str, int]]:
    return [(k, v, s) for k in KINDS for v in VARIANTS for s in SEEDS
            if v in _SHAPES[k]]


def make_case(kind: str, variant: str, seed: int) -> Dict[str, np.ndarray]:
    """Inputs of one batched step, (B, W[, C]) numpy arrays."""
    rng = np.random.default_rng(
        1000 * KINDS.index(kind) + 100 * VARIANTS.index(variant) + seed
    )
    W, C = _SHAPES[kind][variant]
    B = _B
    T = rng.integers(3, 12, B).astype(np.int32)
    if variant == "ties":
        vals = np.array([0.0, -0.0, -0.5, -1.0], np.float32)
        h = rng.choice(vals, (B, W, C))
        lp = rng.choice(vals, (B, W))
    else:
        h = np.log(rng.uniform(0.02, 1.0, (B, W, C))).astype(np.float32)
        lp = np.round(rng.normal(-2.0, 1.0, (B, W)), 1).astype(np.float32)
    fin_p = 0.4 if variant == "finished" else 0.1
    fin = rng.random((B, W)) < fin_p
    hi = T[:, None] + (2 if variant == "finished" else 1)
    t = rng.integers(0, hi, (B, W)).astype(np.int32)
    u = rng.integers(0, 10, (B, W)).astype(np.int32)
    case = dict(h=h.astype(np.float32), lp=lp.astype(np.float32), fin=fin,
                t=t, u=u, T=T)
    if variant == "diagonal":
        # T even, U = T*k + 2, every beam at t = T/2 - 1: the next
        # position's diagonal U/T * T/2 = U/2 is an integer, while f32
        # U/T is rounded; tot_prev + dtab[class] hits U/2 exactly.
        T = 2 * rng.integers(2, 6, B).astype(np.int32)
        U = (T * rng.integers(3, 6, B) + 2).astype(np.int32)
        dtab = np.sort(rng.integers(0, 6, C)).astype(np.int32)
        t = np.broadcast_to((T // 2 - 1)[:, None], (B, W)).astype(np.int32)
        tot = (U // 2)[:, None] - rng.choice(dtab, (B, W))
        return dict(h=h.astype(np.float32), lp=lp.astype(np.float32),
                    fin=np.zeros((B, W), bool), t=t, u=t.copy(), T=T,
                    tot=tot.astype(np.int32), U=U, dtab=dtab)
    if kind == "v2":
        U = (T * rng.integers(3, 6, B)).astype(np.int32)
        diag = (U[:, None] / T[:, None] * (t + 1)).astype(np.int32)
        case["tot"] = np.clip(
            diag + rng.integers(-3, 4, (B, W)), 0, U[:, None]
        ).astype(np.int32)
        case["U"] = U
        case["dtab"] = np.sort(rng.integers(0, 6, C)).astype(np.int32)
    if kind == "v1" and variant == "finished":
        case["max_beam_width"] = W + 3  # widening pads by repetition
    return case


@functools.partial(jax.jit, static_argnames=("kind", "max_beam_width"))
def _xla(kind, h, lp, fin, t, u, T, tot, dtab, U, max_beam_width):
    if kind == "v1":
        return beam_v1.beam_search_decode_batched(
            h, lp, fin, t, u, T, max_beam_width=max_beam_width
        )
    if kind == "v2":
        return beam_v2.beam_search_decode(
            h, lp, fin, tot, dtab, t, u, T, U, return_num_survivors=True
        )
    return tone_latent.beam_search_decode(
        h, lp, fin, t, u, T, empty_tone_id=1
    )


def xla_step(kind: str, case, device=None) -> Dict[str, np.ndarray]:
    """The batched XLA step on `device` (default: JAX's default device)."""
    args = [case[k] for k in ("h", "lp", "fin", "t", "u", "T")]
    args += [case.get("tot"), case.get("dtab"), case.get("U")]
    if device is not None:
        args = [None if a is None else jax.device_put(a, device)
                for a in args]
    outs = _xla(kind, *args, max_beam_width=case.get("max_beam_width"))
    outs = [np.asarray(o) for o in outs]
    if kind == "v2":
        names = _NAMES[:5] + ["total_duration", "beam_branch",
                              "num_survivors"]
    else:
        names = _NAMES
    return dict(zip(names, outs))


def oracle_step(kind: str, case, b: int):
    """The oracle's candidates for utterance b, or None where the reference
    would panic on an empty v2 beam."""
    h, lp, fin = case["h"][b], case["lp"][b], case["fin"][b]
    t, u, T = case["t"][b], case["u"][b], int(case["T"][b])
    W = h.shape[0]
    if kind == "v1":
        res = oracle.v1_beam_search_kernel(
            h, lp, fin, t, u, T, case.get("max_beam_width", W)
        )
        return oracle.candidates_to_arrays(res)
    if kind == "v2":
        try:
            res = oracle.v2_beam_search_kernel(
                h, lp, fin, case["tot"][b], case["dtab"], t, u, T,
                int(case["U"][b]), 0, False, False, W,
            )
        except AssertionError:
            return None
        return oracle.candidates_to_arrays(res, with_duration=True)
    res = oracle.tone_beam_search_kernel(h, lp, fin, t, u, T, 1, W)
    return oracle.candidates_to_arrays(res)


def check(kind: str, variant: str, seed: int, device=None) -> int:
    """Compare one case bit for bit (log-probs by bit pattern, so -0.0 and
    +0.0 differ); raises AssertionError on a mismatch. Returns the number
    of utterances compared."""
    case = make_case(kind, variant, seed)
    got = xla_step(kind, case, device)
    for b in range(case["h"].shape[0]):
        want = oracle_step(kind, case, b)
        if want is None:
            assert got["num_survivors"][b] == 0, (kind, variant, seed, b)
            continue
        for k, w in want.items():
            g = got[k][b]
            if k == "log_prob":
                g, w = g.view(np.int32), w.view(np.int32)
            np.testing.assert_array_equal(
                g, w, err_msg=f"{kind}/{variant}/seed{seed} b={b} {k}"
            )
    return case["h"].shape[0]
