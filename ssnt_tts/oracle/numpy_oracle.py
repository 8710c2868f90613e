"""Plain-Python oracle reimplementing the reference Rust kernel semantics.

Used by the conformance test-suite to check the JAX ops bit-exactly on
randomized inputs. This is intentionally written in the reference's
imperative, per-hypothesis style (lists of candidate records, stable sort,
consecutive dedup) so it is an independent articulation of
/root/reference/src/{lib,v2,tone_latent,util,v2_util,edit_distance}.rs
semantics rather than a vectorized re-derivation that could share bugs with
the JAX implementation. All float math is forced to np.float32 to match the
Rust f32 arithmetic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

f32 = np.float32


@dataclass
class Candidate:
    prediction: int
    log_prob: f32
    next_t: int
    next_u: int
    is_finished: bool
    parent_branch: int
    total_duration: Optional[int] = None

    def eq_ignore_parent(self, other: "Candidate") -> bool:
        same = (
            self.prediction == other.prediction
            and self.log_prob == other.log_prob
            and self.next_t == other.next_t
            and self.next_u == other.next_u
            and self.is_finished == other.is_finished
        )
        if self.total_duration is not None:
            same = same and self.total_duration == other.total_duration
        return same


def _sort_dedup(results: List[Candidate]) -> List[Candidate]:
    # Stable sort desc by log_prob (src/lib.rs:161), then consecutive dedup
    # against the last retained element (src/lib.rs:162).
    results = sorted(results, key=lambda r: -r.log_prob)
    deduped: List[Candidate] = []
    for r in results:
        if deduped and r.eq_ignore_parent(deduped[-1]):
            continue
        deduped.append(r)
    return deduped


def _pad_truncate(results: List[Candidate], max_beam_width: int,
                  modular: bool) -> List[Candidate]:
    n = len(results)
    assert n > 0
    for i in range(max_beam_width - n):
        results.append(results[i % n] if modular else results[i])
    return results[:max_beam_width]


# ---------------------------------------------------------------- v1 (lib.rs)

def v1_beam_search_kernel(h, log_prob_history, is_finished, t, u,
                          input_length, max_beam_width):
    """h: (W, 2) f32; state (W,). Returns list of max_beam_width Candidates."""
    h = np.asarray(h, f32)
    W = h.shape[0]
    results: List[Candidate] = []
    for w in range(W):
        hist = f32(log_prob_history[w])
        tw, uw = int(t[w]), int(u[w])
        if not (0 <= tw < input_length) or is_finished[w]:
            results.append(Candidate(0, hist, tw, uw, True, w))
            continue
        last = tw == input_length - 1
        # Emit
        if last:
            results.append(Candidate(0, f32(hist + h[w, 0]), tw, uw, True, w))
        else:
            results.append(
                Candidate(0, f32(hist + h[w, 0]), tw, uw + 1, False, w)
            )
        # Shift
        if last:
            results.append(Candidate(0, hist, tw, uw, True, w))
        else:
            results.append(
                Candidate(1, f32(hist + h[w, 1]), tw + 1, uw + 1, False, w)
            )
    results = _sort_dedup(results)
    return _pad_truncate(results, max_beam_width, modular=False)


# ----------------------------------------------------------------- v2 (v2.rs)

def v2_beam_search_kernel(h, log_prob_history, is_finished, total_duration,
                          duration_table, t, u, input_length, output_length,
                          zero_duration_id, allow_skip, test_mode,
                          max_beam_width):
    h = np.asarray(h, f32)
    W, D = h.shape
    T, U = int(input_length), int(output_length)
    results: List[Candidate] = []
    for w in range(W):
        hist = f32(log_prob_history[w])
        tw, uw = int(t[w]), int(u[w])
        if not (tw < T) or is_finished[w]:
            results.append(
                Candidate(zero_duration_id, hist, tw, uw, True, w,
                          int(total_duration[w]))
            )
            continue
        diagonal = f32(f32(U) / f32(T) * f32(tw + 1))
        upper_range = f32(f32(U) * f32(0.1))
        lower_range = f32(f32(U) * f32(0.05))
        lower_bound = int(max(f32(diagonal - lower_range), f32(0.0)))
        upper_bound = int(min(f32(diagonal + upper_range), f32(U)))
        remaining = T - (tw + 1)
        overrun = remaining * 3 > U
        last = tw == T - 1
        for d in range(D):
            dur = int(duration_table[d])
            tot = int(total_duration[w]) + dur
            if not test_mode and (tot < lower_bound or tot > upper_bound):
                continue
            if not test_mode and overrun:
                continue
            if last:
                if not test_mode and tot != U:
                    continue
                if not allow_skip and d == zero_duration_id:
                    continue
                results.append(
                    Candidate(d, f32(hist + h[w, d]), tw, uw, True, w, tot)
                )
            else:
                if not allow_skip and d == zero_duration_id:
                    continue
                results.append(
                    Candidate(d, f32(hist + h[w, d]), tw + 1, uw + 1, False,
                              w, tot)
                )
    results = _sort_dedup(results)

    diagonal_result = None
    if not test_mode:
        for r in results:
            diag = f32(f32(U) / f32(T) * f32(r.next_t))
            diff = f32(f32(r.total_duration) - diag)
            if -20.0 <= diff <= 0.0:
                diagonal_result = r
                break

    assert results, "empty v2 beam (reference panics here, src/v2.rs:292)"
    results = _pad_truncate(results, max_beam_width, modular=True)
    if diagonal_result is not None:
        results = results[: max_beam_width - 1] + [diagonal_result]
    return results


# --------------------------------------------------- tone (tone_latent.rs)

def tone_beam_search_kernel(h, log_prob_history, is_finished, t, u,
                            input_length, empty_tone_id, max_beam_width):
    h = np.asarray(h, f32)
    W, K = h.shape
    T = int(input_length)
    results: List[Candidate] = []
    for w in range(W):
        hist = f32(log_prob_history[w])
        tw, uw = int(t[w]), int(u[w])
        if not (tw < T) or is_finished[w]:
            results.append(Candidate(empty_tone_id, hist, tw, uw, True, w))
            continue
        for k in range(K):
            results.append(
                Candidate(k, f32(hist + h[w, k]), tw + 1, uw + 1, False, w)
            )
    results = _sort_dedup(results)
    return _pad_truncate(results, max_beam_width, modular=True)


# ------------------------------------------------------- util / v2_util

def extract_best_beam_branch_kernel(best_final_branch, beam_branch, t_history):
    """(U, W) tables -> backtraced (branches, ts) lists (src/util.rs:20-33)."""
    U = len(beam_branch)
    branches, ts = [], []
    current = int(best_final_branch)
    for row in range(U - 1, -1, -1):
        ts.insert(0, int(t_history[row][current]))
        branches.insert(0, current)
        current = int(beam_branch[row][current])
    return branches, ts


def order_beam_branch(final_branch, beam_branch):
    """(B, W) finals, (B, T, W) parents -> (B, W, T) (src/v2_util.rs:6-36)."""
    final_branch = np.asarray(final_branch)
    beam_branch = np.asarray(beam_branch)
    B, W = final_branch.shape
    Tn = beam_branch.shape[1]
    out = np.zeros((B, W, Tn), np.int32)
    for b in range(B):
        for w in range(W):
            current = int(final_branch[b, w])
            for row in range(Tn - 1, -1, -1):
                out[b, w, row] = current
                current = int(beam_branch[b, row, current])
    return out


def upsample_source_indexes(duration, output_length, max_u, fill):
    """(B, W, T) durations -> (B, W, max_u) indices (src/v2_util.rs:39-66)."""
    duration = np.asarray(duration)
    output_length = np.asarray(output_length)
    B, W, Tn = duration.shape
    out = np.full((B, W, max_u), fill, np.int32)
    for b in range(B):
        for w in range(W):
            expanded = []
            for tpos in range(Tn):
                expanded.extend([tpos] * int(duration[b, w, tpos]))
            assert len(expanded) == int(output_length[b, w])
            out[b, w, : len(expanded)] = expanded
    return out


# --------------------------------------------------------- edit_distance.rs

def levenshtein_edit_distance_kernel(a, b):
    M, N = len(a), len(b)
    e = list(range(N + 1))
    for m in range(1, M + 1):
        e_tmp = [e[0] + 1] + [-1] * N
        for n in range(1, N + 1):
            term1 = e[n - 1] + (0 if a[m - 1] == b[n - 1] else 1)
            term2 = e[n] + 1
            term3 = e_tmp[n - 1] + 1
            e_tmp[n] = min(term1, term2, term3)
        e = e_tmp
    return e[N]


def levenshtein_edit_distance(a, b, a_lengths, b_lengths):
    return [
        levenshtein_edit_distance_kernel(
            list(a[i][: a_lengths[i]]), list(b[i][: b_lengths[i]])
        )
        for i in range(len(a_lengths))
    ]


# ------------------------------------------------ candidate list -> arrays

def candidates_to_arrays(results: List[Candidate], with_duration=False):
    out = dict(
        prediction=np.array([r.prediction for r in results], np.int32),
        log_prob=np.array([r.log_prob for r in results], np.float32),
        next_t=np.array([r.next_t for r in results], np.int32),
        next_u=np.array([r.next_u for r in results], np.int32),
        is_finished=np.array([r.is_finished for r in results], bool),
        beam_branch=np.array([r.parent_branch for r in results], np.int32),
    )
    if with_duration:
        out["total_duration"] = np.array(
            [r.total_duration for r in results], np.int32
        )
    return out
