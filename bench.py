"""Benchmark harness for one NVIDIA GPU. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, "extras": {...}}

Primary metric: SSNT lattice forward+backward throughput, grad(loss) in
Mcells/s at the training shape (B=32, 80 source tokens, 400 mel frames,
ragged lengths, float32) through the dispatched loss (the Pallas walk
kernels on the GPU). Extras: the same at B=256, the XLA scan and blocked
scan at both sizes, v1/v2/tone decode at B=32 with beam 8, and the train
step at B=32 and B=256 at the full width of `ModelConfig()`, with the
dispatched lattice kernels and with the XLA scan.

Every time is the median of repeated calls after warm-up, each ended by
`jax.block_until_ready`, with its quartiles. Progress goes to stderr. The
harness measures only on a GPU: without one it exits non-zero.
"""

import json
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

from ssnt_tts.utils import runtime
from ssnt_tts.utils.profiling import time_call

T, U, W = 80, 400, 8


def _prog(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _lattice_inputs(B, seed=0):
    rng = np.random.default_rng(seed)
    le = np.log(rng.uniform(0.1, 0.9, (U, B, T))).astype(np.float32)
    ls = np.log1p(-np.exp(le)).astype(np.float32)
    lf = rng.normal(0, 0.5, (U, B, T)).astype(np.float32)
    il = rng.integers(T // 2, T + 1, B).astype(np.int32)
    ol = rng.integers(U // 2, U + 1, B).astype(np.int32)
    return [jnp.asarray(x) for x in (le, ls, lf, il, ol)]


def _grad(loss):
    return jax.jit(lambda le, ls, lf, il, ol: jax.grad(
        lambda a, b, c: jnp.sum(loss(a, b, c, il, ol)), argnums=(0, 1, 2)
    )(le, ls, lf))


def _ms(stats):
    return {k: round(v, 4) for k, v in stats.items() if k.endswith("_ms")}


def lattice_section(extras):
    from ssnt_tts.ops import lattice, lattice_scan

    impls = {
        "dispatched": lambda *a: lattice.ssnt_loss(*a, layout="ubt"),
        "xla_scan": lattice.xla_loss_core,
        "blocked_scan": lambda *a: lattice_scan.ssnt_loss_scan(
            *a, layout="ubt"),
    }
    primary = None
    for B in (32, 256):
        args = _lattice_inputs(B)
        for name, loss in impls.items():
            _prog(f"lattice grad B={B} {name}")
            st = time_call(_grad(loss), *args, warmup=3, iters=20)
            mcells = B * T * U / (st["median_ms"] * 1e-3) / 1e6
            extras[f"lattice_grad_B{B}_{name}_ms"] = _ms(st)
            extras[f"lattice_grad_B{B}_{name}_Mcells_per_s"] = round(mcells, 1)
            if B == 32 and name == "dispatched":
                primary = mcells
    return primary


def model_section(extras):
    from ssnt_tts import data as data_lib
    from ssnt_tts.models import SSNTModel
    from ssnt_tts.parallel import decode as decode_lib
    from ssnt_tts.parallel import train as train_lib
    from ssnt_tts.utils.config import ModelConfig, TrainConfig

    cfg = ModelConfig()
    model = SSNTModel(cfg)
    tcfg = TrainConfig(warmup_steps=2)
    tx = train_lib.make_optimizer(tcfg)

    def batch(B):
        ds = data_lib.SyntheticTTSDataset(
            vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
            max_input_length=T, max_output_length=U,
            duration_class_size=cfg.duration_class_size,
            tone_class_size=cfg.tone_class_size, seed=B,
        )
        return {k: jnp.asarray(v) for k, v in ds.batch(B).items()
                if k != "alignment"}

    b32 = batch(32)
    state = train_lib.init_train_state(model, jax.random.PRNGKey(0), b32,
                                       tcfg)
    p = state.params
    tok, il, ol = b32["tokens"], b32["input_length"], b32["output_length"]
    decoders = {
        "v1": (jax.jit(lambda p_: decode_lib.beam_decode(
            model, p_, tok, il, max_frames=U, beam_width=W))),
        "v2": (jax.jit(lambda p_: decode_lib.v2_duration_decode(
            model, p_, tok, il, ol, cfg.duration_table, beam_width=W,
            max_frames=U))),
        "tone": (jax.jit(lambda p_: decode_lib.tone_decode(
            model, p_, tok, il, beam_width=W))),
    }
    for name, fn in decoders.items():
        _prog(f"decode {name} B=32")
        st = time_call(fn, p, warmup=1, iters=5)
        extras[f"decode_{name}_B32_W{W}_ms"] = _ms(st)

    from ssnt_tts.ops import lattice

    for B in (32, 256):
        bt = b32 if B == 32 else batch(256)
        st0 = train_lib.init_train_state(model, jax.random.PRNGKey(0), bt,
                                         tcfg)
        # The step is timed on a fixed state (no donation), so every call
        # does the same work. The second variant traces the step with the
        # XLA scan in place of the dispatched kernels: the kernels'
        # end-to-end effect on the train step.
        for name, core in (("dispatched", None),
                           ("xla_scan", lattice.xla_loss_core)):
            _prog(f"train step B={B} {name}")
            step = jax.jit(lambda s, b: train_lib.train_step(model, tx, s, b))
            with mock.patch.object(lattice, "dispatched_loss_core",
                                   core or lattice.dispatched_loss_core):
                st = time_call(step, st0, bt, warmup=2, iters=10)
            extras[f"train_step_B{B}_{name}_ms"] = _ms(st)


def main():
    runtime.configure_compile_cache()
    dev = runtime.require_gpu()
    extras = {"card": runtime.gpu_name_and_power_limit()}
    primary = lattice_section(extras)
    model_section(extras)
    print(json.dumps({
        "metric": "lattice_fwdbwd_Mcells_per_s",
        "value": round(primary, 1),
        "unit": "Mcells/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extras": extras,
    }))


if __name__ == "__main__":
    main()
