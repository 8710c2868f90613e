"""Build + ctypes bindings for the C++ CPU oracle.

Compiles oracle.cc on demand with g++ into `build/oracle/` of the checkout
(git-ignored; cached by source hash), mirroring the reference's native
packaging (Rust staticlib -> C ABI -> host framework) without any external
build deps.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache

import numpy as np

from ssnt_tts.utils.runtime import REPO_ROOT

_SRC = os.path.join(os.path.dirname(__file__), "cpp", "oracle.cc")
_BUILD_DIR = os.path.join(REPO_ROOT, "build", "oracle")


def _build_lib() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_BUILD_DIR, f"ssnt_oracle_{digest}.so")
    if not os.path.exists(out):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        subprocess.run(
            ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", _SRC, "-o", tmp],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, out)
    return out


i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
i32 = ctypes.c_int32
u8 = ctypes.c_uint8


@lru_cache(maxsize=1)
def load():
    lib = ctypes.CDLL(_build_lib())
    lib.oracle_v1_beam_step.argtypes = [
        f32p, f32p, u8p, i32p, i32p, i32p, i32, i32, i32,
        i32p, f32p, i32p, i32p, u8p, i32p,
    ]
    lib.oracle_v2_beam_step.restype = i32
    lib.oracle_v2_beam_step.argtypes = [
        f32p, f32p, u8p, i32p, i32p, i32p, i32p, i32p, i32p,
        i32, i32, i32, i32, i32, u8, u8,
        i32p, f32p, i32p, i32p, u8p, i32p, i32p,
    ]
    lib.oracle_tone_beam_step.argtypes = [
        f32p, f32p, u8p, i32p, i32p, i32p, i32, i32, i32, i32, i32,
        i32p, f32p, i32p, i32p, u8p, i32p,
    ]
    lib.oracle_extract_best_beam_branch.argtypes = [
        i32p, i32p, i32p, i32, i32, i32, i32p, i32p,
    ]
    lib.oracle_order_beam_branch.argtypes = [
        i32p, i32p, i32, i32, i32, i32p,
    ]
    lib.oracle_upsample.argtypes = [
        i32p, i32p, i32, i32, i32, i32, i32, i32p,
    ]
    lib.oracle_edit_distance.argtypes = [
        i32p, i32p, i32p, i32p, i32, i32, i32p,
    ]
    lib.oracle_ssnt_loss_grad.argtypes = [
        f32p, f32p, f32p, i32p, i32p, i32, i32, i32,
        f32p, f32p, f32p, f32p,
    ]
    return lib


def _c(x, dtype):
    return np.ascontiguousarray(x, dtype=dtype)


def v1_beam_step(h, lph, fin, t, u, input_length, max_w=None):
    lib = load()
    B, W, _ = h.shape
    max_w = max_w or W
    outs = (
        np.zeros((B, max_w), np.int32), np.zeros((B, max_w), np.float32),
        np.zeros((B, max_w), np.int32), np.zeros((B, max_w), np.int32),
        np.zeros((B, max_w), np.uint8), np.zeros((B, max_w), np.int32),
    )
    lib.oracle_v1_beam_step(
        _c(h, np.float32), _c(lph, np.float32),
        _c(fin, np.uint8), _c(t, np.int32), _c(u, np.int32),
        _c(input_length, np.int32), B, W, max_w, *outs,
    )
    pred, lp, nt, nu, nfin, br = outs
    return pred, lp, nt, nu, nfin.astype(bool), br


def v2_beam_step(h, lph, fin, tot, dur_table, t, u, input_length,
                 output_length, zero_duration_id, allow_skip, test_mode,
                 max_w=None):
    lib = load()
    B, W, D = h.shape
    max_w = max_w or W
    outs = (
        np.zeros((B, max_w), np.int32), np.zeros((B, max_w), np.float32),
        np.zeros((B, max_w), np.int32), np.zeros((B, max_w), np.int32),
        np.zeros((B, max_w), np.uint8), np.zeros((B, max_w), np.int32),
        np.zeros((B, max_w), np.int32),
    )
    empties = lib.oracle_v2_beam_step(
        _c(h, np.float32), _c(lph, np.float32), _c(fin, np.uint8),
        _c(tot, np.int32), _c(dur_table, np.int32), _c(t, np.int32),
        _c(u, np.int32), _c(input_length, np.int32),
        _c(output_length, np.int32), B, W, D, max_w,
        zero_duration_id, int(allow_skip), int(test_mode), *outs,
    )
    pred, lp, nt, nu, nfin, totd, br = outs
    return (pred, lp, nt, nu, nfin.astype(bool), totd, br), empties


def tone_beam_step(h, lph, fin, t, u, input_length, empty_tone_id,
                   max_w=None):
    lib = load()
    B, W, K = h.shape
    max_w = max_w or W
    outs = (
        np.zeros((B, max_w), np.int32), np.zeros((B, max_w), np.float32),
        np.zeros((B, max_w), np.int32), np.zeros((B, max_w), np.int32),
        np.zeros((B, max_w), np.uint8), np.zeros((B, max_w), np.int32),
    )
    lib.oracle_tone_beam_step(
        _c(h, np.float32), _c(lph, np.float32), _c(fin, np.uint8),
        _c(t, np.int32), _c(u, np.int32), _c(input_length, np.int32),
        B, W, K, max_w, empty_tone_id, *outs,
    )
    pred, lp, nt, nu, nfin, br = outs
    return pred, lp, nt, nu, nfin.astype(bool), br


def extract_best_beam_branch(best_final, beam_branch, t_history):
    lib = load()
    B, U, W = beam_branch.shape
    ob = np.zeros((B, U), np.int32)
    ot = np.zeros((B, U), np.int32)
    lib.oracle_extract_best_beam_branch(
        _c(best_final, np.int32), _c(beam_branch, np.int32),
        _c(t_history, np.int32), B, U, W, ob, ot,
    )
    return ob, ot


def order_beam_branch(final_branch, beam_branch):
    lib = load()
    B, T, W = beam_branch.shape
    out = np.zeros((B, W, T), np.int32)
    lib.oracle_order_beam_branch(
        _c(final_branch, np.int32), _c(beam_branch, np.int32), B, T, W, out
    )
    return out


def upsample(duration, output_length, max_u, fill):
    lib = load()
    B, W, T = duration.shape
    out = np.zeros((B, W, max_u), np.int32)
    lib.oracle_upsample(
        _c(duration, np.int32), _c(output_length, np.int32),
        B, W, T, max_u, fill, out,
    )
    return out


def edit_distance(a, b, a_len, b_len):
    lib = load()
    B, L = a.shape
    out = np.zeros((B,), np.int32)
    lib.oracle_edit_distance(
        _c(a, np.int32), _c(b, np.int32), _c(a_len, np.int32),
        _c(b_len, np.int32), B, L, out,
    )
    return out


def ssnt_loss_grad(log_emit, log_shift, log_frame, input_length,
                   output_length):
    lib = load()
    B, T, U = log_emit.shape
    loss = np.zeros((B,), np.float32)
    ge = np.zeros((B, T, U), np.float32)
    gs = np.zeros((B, T, U), np.float32)
    gf = np.zeros((B, T, U), np.float32)
    lib.oracle_ssnt_loss_grad(
        _c(log_emit, np.float32), _c(log_shift, np.float32),
        _c(log_frame, np.float32), _c(input_length, np.int32),
        _c(output_length, np.int32), B, T, U, loss, ge, gs, gf,
    )
    return loss, ge, gs, gf
