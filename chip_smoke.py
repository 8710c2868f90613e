"""Smoke test of the whole system on an NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the multi-card paths only
                                   # (full width, one encoder layer)

One card, at the full width of `ModelConfig()` with random weights from a
seed, T=80 tokens and U=400 frames (`TrainConfig`):

  (a) the card's name and power limit;
  (b) the lattice loss: the Pallas walk kernels against the XLA scan and
      the fp64 C++ oracle, then grad(loss) timings of the XLA scan, the
      blocked scan (ops/lattice_scan.py) and the kernels at B=32 and B=256;
  (c) training through `train_loop.run_training` at B=32 with a
      checkpoint save and a resume, one step at B=256, and train-step
      timings;
  (d) v1, v2 and tone beam decode at B=32, W=8, max_frames=400 on the
      trained parameters, with timings;
  (e) the v1/v2/tone beam steps on the card against the numpy oracle, bit
      for bit (ssnt_tts/oracle/beam_grid.py), and the test suite's
      `gpu`-marked tests;
  (f) the float32 model forward (training NLL and the decode steps' h) on
      the card against the same code on the CPU at the highest matmul
      precision, and the share of decoded best paths that differ from the
      CPU's, at the highest and at the default (TF32) precision. Then each
      decoder runs in lockstep: the CPU decodes, and every step also runs
      on the card from the CPU's carry. The card's selection given the
      CPU's h must be the CPU's step bit for bit, and wherever the card's
      own h changes the selection, the CPU's candidate scores must have
      been within the card's h error of a tie.

Every check raises on failure, so any failed phase exits non-zero. The last
line of standard output is one JSON object naming the device. Without a
GPU the script exits non-zero before printing it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

T_TOKENS, U_FRAMES, BEAM = 80, 400, 8


def log(msg: str):
    print(msg, flush=True)


def _ragged_lattice(B, seed=0):
    rng = np.random.default_rng(seed)
    U, T = U_FRAMES, T_TOKENS
    le = np.log(rng.uniform(0.1, 0.9, (U, B, T))).astype(np.float32)
    ls = np.log1p(-np.exp(le)).astype(np.float32)
    lf = rng.normal(0, 0.5, (U, B, T)).astype(np.float32)
    il = rng.integers(T // 2, T + 1, B).astype(np.int32)
    ol = rng.integers(U // 2, U + 1, B).astype(np.int32)
    il[0], ol[0] = T, U  # one full-size utterance
    return le, ls, lf, il, ol


def _grad_fn(loss):
    def f(le, ls, lf, il, ol):
        return jax.grad(
            lambda a, b, c: jnp.sum(loss(a, b, c, il, ol)), argnums=(0, 1, 2)
        )(le, ls, lf)

    return jax.jit(f)


def phase_lattice():
    from ssnt_tts.oracle import build as cpp
    from ssnt_tts.ops import lattice, lattice_scan
    from ssnt_tts.utils.profiling import format_time, time_call

    dispatched = lambda *a: lattice.ssnt_loss(*a, layout="ubt")
    blocked = lambda *a: lattice_scan.ssnt_loss_scan(*a, layout="ubt")
    for B in (32, 256):
        args = _ragged_lattice(B)
        dev = [jnp.asarray(x) for x in args]
        hlo = _grad_fn(dispatched).lower(*dev).as_text()
        assert hlo.count("__gpu$xla.gpu.triton") == 2, "kernels not dispatched"
        nll_x = np.asarray(jax.jit(lattice.xla_loss_core)(*dev))
        nll_k = np.asarray(jax.jit(dispatched)(*dev))
        g_x = _grad_fn(lattice.xla_loss_core)(*dev)
        g_k = _grad_fn(dispatched)(*dev)
        rel = float(np.max(np.abs(nll_k - nll_x) / np.abs(nll_x)))
        gabs = max(float(jnp.max(jnp.abs(a - b))) for a, b in zip(g_k, g_x))
        log(f"lattice B={B}: kernel vs XLA scan: NLL max rel err {rel:.3e} "
            f"(tol 1e-5), grad max abs err {gabs:.3e} (tol 1e-5)")
        assert rel <= 1e-5 and gabs <= 1e-5, (rel, gabs)
        if B == 32:
            # fp64 C++ oracle, (B, T, U) layout; tolerances of
            # tests/test_cpp_oracle.py.
            le, ls, lf, il, ol = (
                np.ascontiguousarray(np.transpose(x, (1, 2, 0)))
                if x.ndim == 3 else x for x in args
            )
            c_loss, *c_grads = cpp.ssnt_loss_grad(le, ls, lf, il, ol)
            k_grads = [np.transpose(np.asarray(g), (1, 2, 0)) for g in g_k]
            np.testing.assert_allclose(nll_k, c_loss, rtol=2e-4, atol=2e-4)
            for kg, cg in zip(k_grads, c_grads):
                np.testing.assert_allclose(kg, cg, rtol=2e-3, atol=2e-4)
            lrel = float(np.max(np.abs(nll_k - c_loss) / np.abs(c_loss)))
            gmax = max(float(np.max(np.abs(a - b)))
                       for a, b in zip(k_grads, c_grads))
            log(f"lattice B=32: kernel vs fp64 C++ oracle: NLL max rel err "
                f"{lrel:.3e} (tol 2e-4), grad max abs err {gmax:.3e} "
                f"(tol 2e-4 + 2e-3 rel)")
        for name, loss in (("XLA scan", lattice.xla_loss_core),
                           ("blocked scan", blocked),
                           ("Pallas kernels (dispatched)", dispatched)):
            st = time_call(_grad_fn(loss), *dev, warmup=3, iters=20)
            log(f"time lattice grad(loss) B={B} T={T_TOKENS} U={U_FRAMES} "
                f"f32 ragged, {name}: {format_time(st)}")


def _train_config(B):
    from ssnt_tts.utils.config import TrainConfig

    return TrainConfig(batch_size=B, warmup_steps=2)


def phase_train(work):
    from ssnt_tts import data as data_lib
    from ssnt_tts.models import SSNTModel
    from ssnt_tts.parallel import mesh as mesh_lib
    from ssnt_tts.parallel import train as train_lib
    from ssnt_tts.train_loop import run_training
    from ssnt_tts.utils import checkpoint as ckpt_lib
    from ssnt_tts.utils.config import MeshConfig, ModelConfig
    from ssnt_tts.utils.profiling import format_time

    cfg = ModelConfig()
    ckpt = os.path.join(work, "ckpt")
    metrics = os.path.join(work, "metrics.jsonl")
    kw = dict(model_config=cfg, train_config=_train_config(32),
              mesh_config=MeshConfig(1, 1), checkpoint_dir=ckpt,
              checkpoint_every=3, log_every=1, metrics_path=metrics)
    t0 = time.perf_counter()
    run_training(num_steps=3, **kw)
    assert ckpt_lib.latest_step(ckpt) == 3
    run_training(num_steps=6, **kw)  # resumes at step 3
    assert ckpt_lib.latest_step(ckpt) == 6
    with open(metrics) as f:
        recs = [json.loads(line) for line in f]
    steps = [r["step"] for r in recs]
    losses = [r["loss"] for r in recs]
    log(f"train B=32 full width: steps {steps} losses "
        f"{[round(x, 4) for x in losses]} (save at 3, resume to 6; "
        f"{time.perf_counter() - t0:.1f} s incl. compile)")
    assert steps == [1, 2, 3, 4, 5, 6], steps
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses

    t0 = time.perf_counter()
    m = run_training(num_steps=1, model_config=cfg,
                     train_config=_train_config(256),
                     mesh_config=MeshConfig(1, 1), log_every=1)
    log(f"train B=256 full width: one step, loss {m['loss']:.4f} "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")
    assert np.isfinite(m["loss"])

    model = SSNTModel(cfg)
    mesh = mesh_lib.make_mesh(MeshConfig(1, 1))
    tx = train_lib.make_optimizer(_train_config(32))
    for B in (32, 256):
        ds = data_lib.SyntheticTTSDataset(
            vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
            max_input_length=T_TOKENS, max_output_length=U_FRAMES,
            duration_class_size=cfg.duration_class_size,
            tone_class_size=cfg.tone_class_size, seed=B,
        )
        batch = {k: v for k, v in ds.batch(B).items() if k != "alignment"}
        state = train_lib.init_train_state(
            model, jax.random.PRNGKey(0), batch, _train_config(B)
        )
        step_fn, state = train_lib.make_sharded_train_step(
            model, tx, mesh, state
        )
        batch = jax.device_put(batch, mesh_lib.data_sharding(mesh))
        ts = []
        for i in range(13):
            t0 = time.perf_counter()
            state, met = step_fn(state, batch)
            jax.block_until_ready(state)
            if i >= 3:
                ts.append((time.perf_counter() - t0) * 1e3)
        ms = np.asarray(ts)
        st = {"median_ms": float(np.median(ms)),
              "q25_ms": float(np.percentile(ms, 25)),
              "q75_ms": float(np.percentile(ms, 75)),
              "min_ms": float(ms.min()), "max_ms": float(ms.max()),
              "n": len(ts)}
        assert np.isfinite(float(met["loss"]))
        log(f"time train step B={B} full width (bf16, with aux heads, "
            f"optimizer): {format_time(st)}")

    like = train_lib.init_train_state(
        model, jax.random.PRNGKey(0),
        {k: v for k, v in data_lib.SyntheticTTSDataset(
            vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
            max_input_length=T_TOKENS, max_output_length=U_FRAMES,
        ).batch(32).items() if k != "alignment"},
        _train_config(32),
    )
    return ckpt_lib.restore(ckpt, like).params


def _decode_batch(cfg, B, seed=7):
    from ssnt_tts import data as data_lib

    ds = data_lib.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
        max_input_length=T_TOKENS, max_output_length=U_FRAMES,
        duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=seed,
    )
    b = ds.batch(B)
    return {k: jnp.asarray(b[k]) for k in
            ("tokens", "mel", "input_length", "output_length")}


def _decoders(model):
    from ssnt_tts.parallel import decode as decode_lib

    cfg = model.config
    v1 = jax.jit(lambda p, tok, il: decode_lib.beam_decode(
        model, p, tok, il, max_frames=U_FRAMES, beam_width=BEAM))
    v2 = jax.jit(lambda p, tok, il, ol: decode_lib.v2_duration_decode(
        model, p, tok, il, ol, cfg.duration_table, beam_width=BEAM,
        max_frames=U_FRAMES))
    tone = jax.jit(lambda p, tok, il: decode_lib.tone_decode(
        model, p, tok, il, beam_width=BEAM))
    return v1, v2, tone


def phase_decode(params):
    from ssnt_tts.models import SSNTModel
    from ssnt_tts.utils.config import ModelConfig
    from ssnt_tts.utils.profiling import format_time, time_call

    model = SSNTModel(ModelConfig())
    params = jax.device_put(params)  # restored as NumPy arrays
    b = _decode_batch(model.config, 32)
    tok, il, ol = b["tokens"], b["input_length"], b["output_length"]
    v1, v2, tone = _decoders(model)

    out = v1(params, tok, il)
    align = np.asarray(out["alignment"])
    assert out["mel"].shape == (32, U_FRAMES, model.config.mel_dim)
    assert np.isfinite(np.asarray(out["mel"])).all()
    assert np.isfinite(np.asarray(out["log_prob"])).all()
    steps = np.diff(align, axis=1)
    assert (align[:, 0] == 0).all() and np.isin(steps, (0, 1)).all()
    assert (align < np.asarray(il)[:, None]).all()
    log(f"decode v1 B=32 W={BEAM}: alignments monotone, best-beam frames "
        f"{np.asarray(out['num_frames'])[:4].tolist()}...")

    out = v2(params, tok, il, ol)
    durs = np.asarray(out["durations"])
    assert np.isfinite(np.asarray(out["log_prob"])).all()
    np.testing.assert_array_equal(durs.sum(-1),
                                  np.asarray(out["output_length"]))
    emptied = np.asarray(out["beam_emptied"])
    hit = np.asarray(out["output_length"])[:, 0] == np.asarray(ol)
    log(f"decode v2 B=32 W={BEAM}: {int(emptied.sum())} beams emptied, "
        f"{int(hit[~emptied].sum())}/{int((~emptied).sum())} non-emptied "
        f"land exactly on output_length")
    assert hit[~emptied].all()

    out = tone(params, tok, il)
    tones = np.asarray(out["tones"])
    assert tones.shape == (32, BEAM, T_TOKENS)
    assert ((tones >= 0) & (tones < model.config.tone_class_size)).all()
    assert np.isfinite(np.asarray(out["log_prob"])).all()
    log(f"decode tone B=32 W={BEAM}: tones in range")

    for name, fn, args in (("v1", v1, (params, tok, il)),
                           ("v2", v2, (params, tok, il, ol)),
                           ("tone", tone, (params, tok, il))):
        st = time_call(fn, *args, warmup=1, iters=5)
        log(f"time decode {name} B=32 W={BEAM} T={T_TOKENS} "
            f"max_frames={U_FRAMES} (XLA step): {format_time(st)}")


def phase_gpu_tests():
    """The test suite's `gpu`-marked tests, in this process (a second JAX
    process could not get the card's memory)."""
    import pytest

    from ssnt_tts.utils import runtime

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(runtime.REPO_ROOT, "tests")])
    assert rc == 0, f"gpu-marked tests: pytest exit code {rc}"


def phase_beam_steps():
    from ssnt_tts.oracle import beam_grid

    gpu = jax.devices()[0]
    n = sum(beam_grid.check(k, v, s, device=gpu)
            for k, v, s in beam_grid.cases())
    log(f"beam steps on {gpu.device_kind}: {len(beam_grid.cases())} "
        f"batched cases, {n} utterances, bit-exact vs the numpy oracle")


def _lockstep_specs(cfg):
    """Per decoder: its initial carry, model half, selection half (called
    as select(h, carry, model_out, input_length, output_length)), where
    its carry holds log_prob_history, and its number of steps."""
    from ssnt_tts.parallel import decode as d

    table = np.asarray(cfg.duration_table, np.int32)
    return {
        "v1": (d.v1_carry0, d.v1_model_step,
               lambda h, c, mo, il, ol: d.v1_select_step(h, c, mo, il),
               2, U_FRAMES),
        "v2": (d.v2_carry0, d.v2_model_step,
               lambda h, c, mo, il, ol: d.v2_select_step(
                   h, c, mo, table, il, ol),
               0, T_TOKENS),
        "tone": (d.tone_carry0, d.tone_model_step,
                 lambda h, c, mo, il, ol: d.tone_select_step(h, c, mo, il),
                 0, T_TOKENS),
    }


def _near_tie(hist, h_ref, h_other):
    """One utterance's step: the smallest gap between two of its candidate
    scores on the reference device (hist + h for every beam and class, and
    hist alone for the padding and last-frame candidates), and the most
    the other device's h can move any such gap (twice the largest h
    difference plus rounding). The selection orders and dedups candidates
    by score alone, so it can differ only where gap <= bound. Beams equal
    in hist and in both h count once: their candidates tie on both
    devices and keep their order."""
    seen, rows = set(), []
    for w in range(hist.shape[0]):
        key = (hist[w].tobytes(), h_ref[w].tobytes(), h_other[w].tobytes())
        if key not in seen:
            seen.add(key)
            rows.append(w)
    hist_r = hist[rows][:, None]
    s = np.concatenate([hist_r + h_ref[rows], hist_r], axis=1).ravel()
    s = np.sort(s[np.isfinite(s)])
    gap = float(np.diff(s).min()) if s.size > 1 else np.inf
    bound = (2 * float(np.max(np.abs(h_other - h_ref)))
             + 2 * float(np.spacing(np.float32(np.abs(s).max()))))
    return gap, bound


def _discrete(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)
            if not jnp.issubdtype(x.dtype, jnp.floating)]


def _lockstep(model, params, b, precisions, ref_dev, dev):
    """Decode on `ref_dev`, and at every step also run that step on `dev`
    from the same carry. Asserts that `dev`'s selection given `ref_dev`'s
    h is `ref_dev`'s step bit for bit, and that wherever `dev`'s own h
    changes the selection, the candidates were within `_near_tie`'s bound.
    Returns per decoder and precision the count of (step, utterance)
    selections that differ, the largest gap and bound among them, and the
    median gap over all (step, utterance)."""
    cfg = model.config
    B = b["tokens"].shape[0]
    on = jax.device_put
    enc_fn = jax.jit(lambda p, tok, il: model.apply(p, tok, il,
                                                    method=model.encode))
    p_r, p_d = on(params, ref_dev), on(params, dev)
    lens = (b["input_length"], b["output_length"])
    lens_r, lens_d = on(lens, ref_dev), on(lens, dev)
    with jax.default_matmul_precision("highest"):
        enc_r = enc_fn(p_r, on(b["tokens"], ref_dev), lens_r[0])
    enc_d = {}
    for prec in precisions:
        with jax.default_matmul_precision(prec):
            enc_d[prec] = enc_fn(p_d, on(b["tokens"], dev), lens_d[0])
    out = {}
    for name, (carry0, model_step, select, lp_at, n) in (
            _lockstep_specs(cfg).items()):
        m = jax.jit(lambda p, e, c, _f=model_step: _f(model, p, e, c))
        sel = jax.jit(select)
        carry = on(carry0(B, BEAM, cfg), ref_dev)
        st = {prec: {"events": 0, "gap": 0.0, "bound": 0.0, "all": []}
              for prec in precisions}
        for i in range(n):
            with jax.default_matmul_precision("highest"):
                h_r, mo_r = m(p_r, enc_r, carry)
                new_r = sel(h_r, carry, mo_r, *lens_r)
            h_c, carry_d, mo_d = on((h_r, carry, mo_r), dev)
            new_d = sel(h_c, carry_d, mo_d, *lens_d)
            for j, (a, r) in enumerate(zip(jax.tree.leaves(new_d),
                                           jax.tree.leaves(new_r))):
                a, r = np.asarray(a), np.asarray(r)
                if a.tobytes() != r.tobytes():
                    bad = np.flatnonzero((a != r).reshape(B, -1).any(axis=1))
                    raise AssertionError(
                        f"{name} step {i}: the selection from the same h "
                        f"differs in output {j} for utterances "
                        f"{bad.tolist()} (lengths "
                        f"{np.asarray(lens[0])[bad].tolist()}, "
                        f"{np.asarray(lens[1])[bad].tolist()}): "
                        f"{a[bad[0]].tolist()} vs {r[bad[0]].tolist()}")
            hist, hr = np.asarray(carry[lp_at]), np.asarray(h_r)
            ref_disc = _discrete(new_r)
            for prec in precisions:
                with jax.default_matmul_precision(prec):
                    h_d, _ = m(p_d, enc_d[prec], carry_d)
                    new_dd = sel(h_d, carry_d, mo_d, *lens_d)
                hd = np.asarray(h_d)
                differs = np.zeros(B, bool)
                for a, r in zip(_discrete(new_dd), ref_disc):
                    differs |= (a != r).reshape(B, -1).any(axis=1)
                for bi in range(B):
                    gap, bound = _near_tie(hist[bi], hr[bi], hd[bi])
                    st[prec]["all"].append(gap)
                    if differs[bi]:
                        assert gap <= bound, (
                            f"{name} {prec} step {i} utterance {bi}: the "
                            f"selection differs at a clear margin "
                            f"{gap:.3e} > {bound:.3e}")
                        st[prec]["events"] += 1
                        st[prec]["gap"] = max(st[prec]["gap"], gap)
                        st[prec]["bound"] = max(st[prec]["bound"], bound)
            carry = new_r[0]
        for prec in precisions:
            st[prec]["median_gap"] = float(np.median(st[prec].pop("all")))
            st[prec]["steps"] = n * B
        out[name] = st
    return out


def phase_gpu_vs_cpu(params, cfg):
    from ssnt_tts.models import SSNTModel

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    model = SSNTModel(cfg)
    b = _decode_batch(cfg, 32, seed=11)
    rng = np.random.default_rng(12)
    beam_t = rng.integers(0, T_TOKENS, (32, BEAM)).astype(np.int32)
    state = rng.normal(0, 1, (32, BEAM, cfg.decoder_dim)).astype(np.float32)
    prev_mel = rng.normal(0, 1, (32, BEAM, cfg.mel_dim)).astype(np.float32)
    prev_cls = rng.integers(0, 4, (32, BEAM)).astype(np.int32)
    fwd = jax.jit(lambda p, tok, mel, il, ol: model.apply(p, tok, mel, il, ol))

    @jax.jit
    def step_h(p, tok, il):
        # The decode steps' conditioning h from one random beam state.
        enc = model.apply(p, tok, il, method=model.encode)
        h1, _, _ = model.apply(p, enc, beam_t, state, prev_mel,
                               method=model.decode_step)
        h2, _ = model.apply(p, enc, beam_t, state, prev_cls,
                            method=model.duration_decode_step)
        h3, _ = model.apply(p, enc, beam_t, state, prev_cls,
                            method=model.tone_decode_step)
        return {"v1": h1, "v2": h2, "tone": h3}

    v1, v2, tone = _decoders(model)

    def run(device, precision):
        put = lambda x: jax.device_put(x, device)
        p = put(params)
        tok, mel, il, ol = (put(b[k]) for k in
                            ("tokens", "mel", "input_length",
                             "output_length"))
        with jax.default_matmul_precision(precision):
            nll = np.asarray(fwd(p, tok, mel, il, ol))
            hs = jax.device_get(step_h(p, tok, il))
            o1, o2, o3 = v1(p, tok, il), v2(p, tok, il, ol), tone(p, tok, il)
        paths = {"v1": o1["alignment"], "v2": o2["durations"][:, 0],
                 "tone": o3["tones"][:, 0]}
        return nll, hs, {k: np.asarray(v) for k, v in paths.items()}

    names = {"highest": "highest", "default": "default (TF32)"}
    nll_c, h_c, paths_c = run(cpu, "highest")
    for precision in names:
        nll_g, h_g, paths_g = run(gpu, precision)
        tol = precision == "highest"
        rel = float(np.max(np.abs(nll_g - nll_c) / np.abs(nll_c)))
        herr = {k: float(np.max(np.abs(h_g[k] - h_c[k]))) for k in h_c}
        log(f"f32 model, GPU {names[precision]} vs CPU highest: training NLL "
            f"max rel err {rel:.3e}" + (" (tol 1e-4)" if tol else "")
            + "; decode-step h max abs err "
            + ", ".join(f"{k} {v:.3e}" for k, v in herr.items())
            + (" (tol 1e-4)" if tol else ""))
        if tol:
            assert rel <= 1e-4 and max(herr.values()) <= 1e-4, (rel, herr)
        for k in paths_c:
            diff = ~np.all(paths_g[k] == paths_c[k], axis=1)
            log(f"f32 {k} decode, GPU {names[precision]} vs CPU highest: "
                f"{diff.mean():.3f} of best paths differ "
                f"({int(diff.sum())}/32)")

    # Why paths differ: decode on the CPU and run each step on the GPU
    # from the CPU's carry (asserts in _lockstep).
    res = _lockstep(model, params, b, tuple(names), cpu, gpu)
    for name, st in res.items():
        log(f"lockstep {name}: the GPU's selection from the CPU's h is the "
            f"CPU's step bit for bit at all {st['highest']['steps']} "
            f"(step, utterance)")
        for precision, r in st.items():
            log(f"lockstep {name}, GPU h at {names[precision]}: "
                f"{r['events']} of {r['steps']} (step, utterance) selections "
                f"differ from the CPU's, each at a near-tie (largest CPU "
                f"score gap {r['gap']:.3e} <= its bound, largest bound "
                f"{r['bound']:.3e}); median gap over all "
                f"{r['median_gap']:.3e}")


def phase_four():
    """Data-parallel and data x model training, data-sharded decode and
    the T-sharded lattice on four cards, each against one card."""
    from ssnt_tts import data as data_lib
    from ssnt_tts.models import SSNTModel
    from ssnt_tts.ops import lattice, lattice_sharded
    from ssnt_tts.parallel import decode as decode_lib
    from ssnt_tts.parallel import mesh as mesh_lib
    from ssnt_tts.parallel import train as train_lib
    from ssnt_tts.utils.config import MeshConfig, ModelConfig

    devs = jax.devices()
    assert len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}"
    # Full width, encoder depth cut to one layer to bound compile time.
    # float32 at the highest matmul precision: with bf16 compute, the
    # per-card batch shape alone changes how XLA blocks a matmul and so
    # where bf16 rounds. One plain-SGD step: the update is -lr * grad, so
    # the updated parameters compare the gradients themselves.
    cfg = ModelConfig(dtype="float32", encoder_layers=1)
    model = SSNTModel(cfg)
    tx = optax.sgd(1e-3)
    ds = data_lib.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
        max_input_length=T_TOKENS, max_output_length=U_FRAMES,
        duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=3,
    )
    batch = {k: v for k, v in ds.batch(32).items() if k != "alignment"}
    params0 = jax.device_get(model.init(jax.random.PRNGKey(0)))
    # The same parameters moved by one float32 ulp, each up or down.
    sign = np.random.default_rng(4)
    params_ulp = jax.tree.map(
        lambda x: (x * (1 + np.float32(2.0 ** -23)
                        * sign.choice([-1, 1], np.shape(x))))
        .astype(np.float32), params0)

    def train(mesh_cfg, devices, inits):
        """One SGD step from each of `inits` on `mesh_cfg`: the losses and
        the updates (new - old parameters)."""
        mesh = mesh_lib.make_mesh(mesh_cfg, devices=devices)
        data = jax.device_put(batch, mesh_lib.data_sharding(mesh))
        step_fn = shardings = None
        out = []
        for p0 in inits:
            p = jax.tree.map(jnp.asarray, p0)
            state = train_lib.TrainState(step=jnp.zeros((), jnp.int32),
                                         params=p, opt_state=tx.init(p))
            if step_fn is None:
                step_fn, st = train_lib.make_sharded_train_step(
                    model, tx, mesh, state)
                shardings = jax.tree.map(lambda x: x.sharding, st)
            else:
                st = jax.device_put(state, shardings)
            st, met = step_fn(st, data)
            out.append((float(met["loss"]), jax.tree.map(
                lambda new, old: np.asarray(new) - old,
                jax.device_get(st.params), p0)))
        return out

    def rel_l2(a, b):
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        num = sum(float(np.sum((x - y) ** 2)) for x, y in zip(la, lb))
        return np.sqrt(num / sum(float(np.sum(y ** 2)) for y in lb))

    with jax.default_matmul_precision("highest"):
        (ref_loss, ref_upd), (ulp_loss, ulp_upd) = train(
            MeshConfig(1, 1), devs[:1], [params0, params_ulp])
        runs = {shape: train(MeshConfig(*shape), devs, [params0])[0]
                for shape in ((4, 1), (2, 2))}
    # The noise floor, measured in this run on one card: how far a one-ulp
    # change of the parameters moves the loss and the update. The lattice
    # walks add log-probabilities of magnitude ~1e3 over 400 columns, so a
    # last-bit change of their inputs moves the posteriors, and with them
    # every gradient, by ~1e-4 to 1e-3 relative. A different batch split
    # or matmul split is such a change; a sharding fault (a lost, doubled
    # or misplaced shard) moves the update by O(1).
    floor_loss = abs(ulp_loss - ref_loss) / abs(ref_loss)
    floor_upd = rel_l2(ulp_upd, ref_upd)
    tol_loss, tol_upd = 10 * floor_loss + 1e-6, 10 * floor_upd + 1e-6
    log(f"four cards: one-card noise floor (parameters moved by one ulp), "
        f"B=32 (f32, highest): loss rel change {floor_loss:.3e}, SGD update "
        f"rel L2 change {floor_upd:.3e}; tolerances 10x floor + 1e-6: "
        f"{tol_loss:.3e}, {tol_upd:.3e}")
    scale = max(float(np.max(np.abs(x))) for x in jax.tree.leaves(ref_upd))
    for shape, (loss, upd) in runs.items():
        lrel = abs(loss - ref_loss) / abs(ref_loss)
        urel = rel_l2(upd, ref_upd)
        umax = max(float(np.max(np.abs(a - b))) for a, b in zip(
            jax.tree.leaves(upd), jax.tree.leaves(ref_upd))) / scale
        log(f"four cards: train step mesh {shape[0]}x{shape[1]} vs one card, "
            f"B=32 (f32, highest): loss {loss:.6f} vs {ref_loss:.6f} (rel "
            f"err {lrel:.3e}, tol {tol_loss:.3e}); SGD update rel L2 err "
            f"{urel:.3e} (tol {tol_upd:.3e}), max abs err {umax:.3e} of the "
            f"largest update")
        assert lrel <= tol_loss and urel <= tol_upd, (shape, lrel, urel)

    b = _decode_batch(cfg, 32)
    params = jax.tree.map(jnp.asarray, params0)
    keys = ("tokens", "input_length", "output_length")
    mesh = mesh_lib.make_mesh(MeshConfig(4, 1), devices=devs)
    shard = mesh_lib.data_sharding(mesh)
    rng = np.random.default_rng(13)
    beam_t = rng.integers(0, T_TOKENS, (32, BEAM)).astype(np.int32)
    state = rng.normal(0, 1, (32, BEAM, cfg.decoder_dim)).astype(np.float32)
    prev = rng.integers(0, 4, (32, BEAM)).astype(np.int32)

    @jax.jit
    def step_h(p, tok, il, t, st, pc):
        enc = model.apply(p, tok, il, method=model.encode)
        return model.apply(p, enc, t, st, pc,
                           method=model.duration_decode_step)[0]

    dec = jax.jit(lambda p, tok, il, ol: decode_lib.v2_duration_decode(
        model, p, tok, il, ol, cfg.duration_table, beam_width=BEAM,
        max_frames=U_FRAMES))
    with jax.default_matmul_precision("highest"):
        on_one = [jax.device_put(x, devs[0])
                  for x in (b["tokens"], b["input_length"], beam_t, state,
                            prev)]
        on_four = [jax.device_put(x, shard)
                   for x in (b["tokens"], b["input_length"], beam_t, state,
                             prev)]
        h1 = np.asarray(step_h(jax.device_put(params, devs[0]), *on_one))
        h4 = np.asarray(step_h(jax.device_put(params,
                                              mesh_lib.replicated(mesh)),
                               *on_four))
        one = dec(jax.device_put(params, devs[0]),
                  *(jax.device_put(b[k], devs[0]) for k in keys))
        four = dec(jax.device_put(params, mesh_lib.replicated(mesh)),
                   *(jax.device_put(b[k], shard) for k in keys))
    herr = float(np.max(np.abs(h4 - h1)))
    same = np.all(np.asarray(one["durations"]) ==
                  np.asarray(four["durations"]), axis=(1, 2))
    log(f"four cards: data-sharded v2 decode B=32 W={BEAM} (f32, highest) "
        f"vs one card: decode-step h max abs err {herr:.3e} (tol 1e-4, as "
        f"in the one-card GPU vs CPU check); {int(same.sum())}/32 "
        f"utterances decode identically")
    assert herr <= 1e-4, herr
    for out in (one, four):
        live = ~np.asarray(out["beam_emptied"])
        np.testing.assert_array_equal(
            np.asarray(out["output_length"])[live, 0],
            np.asarray(b["output_length"])[live])

    le, ls, lf, il, ol = _ragged_lattice(32, seed=5)
    tmesh = mesh_lib.make_mesh(MeshConfig(1, 4), devices=devs)
    f_sh = jax.jit(jax.value_and_grad(
        lambda a, b_, c: jnp.sum(lattice_sharded.ssnt_loss_tsharded(
            a, b_, c, il, ol, tmesh, axis="model")), argnums=(0, 1, 2)))
    f_one = jax.jit(jax.value_and_grad(
        lambda a, b_, c: jnp.sum(lattice.ssnt_loss(
            a, b_, c, il, ol, layout="ubt")), argnums=(0, 1, 2)))
    v_sh, g_sh = f_sh(le, ls, lf)
    v_one, g_one = f_one(*(jax.device_put(x, devs[0]) for x in (le, ls, lf)))
    rel = abs(float(v_sh) - float(v_one)) / abs(float(v_one))
    gmax = max(float(jnp.max(jnp.abs(jnp.asarray(a) - jnp.asarray(b_))))
               for a, b_ in zip(jax.device_get(g_sh), jax.device_get(g_one)))
    log(f"four cards: T-sharded ring lattice (T={T_TOKENS} over 4) B=32 "
        f"U={U_FRAMES} vs unsharded: loss rel err {rel:.3e} (tol 1e-5), "
        f"grad max abs err {gmax:.3e} (tol 5e-4)")
    # The ring's gradient is autodiff through the scan, the one-card
    # gradient the custom_vjp posteriors: the two orders differ by
    # 8.5e-5 at U=400 (measured on four H100s).
    assert rel <= 1e-5 and gmax <= 5e-4, (rel, gmax)

    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in devs]
    log("four cards: peak bytes in use per card: "
        + ", ".join(f"{d.id}: {p / 2**20:.1f} MiB"
                    for d, p in zip(devs, peaks)))
    assert min(peaks[1:]) > 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args(argv)

    from ssnt_tts.utils import runtime
    from ssnt_tts.utils.config import ModelConfig

    dev = runtime.require_gpu()
    runtime.configure_compile_cache()
    log(runtime.gpu_name_and_power_limit())
    log(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}")

    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        work = os.path.join(runtime.REPO_ROOT, "build", "chip_smoke")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        try:
            phase_lattice()
            log(f"[{time.perf_counter() - t0:.0f} s] lattice phase done")
            params = phase_train(work)
            log(f"[{time.perf_counter() - t0:.0f} s] training phase done")
            phase_decode(params)
            log(f"[{time.perf_counter() - t0:.0f} s] decode phase done")
            phase_beam_steps()
            phase_gpu_tests()
            log(f"[{time.perf_counter() - t0:.0f} s] beam-step and gpu-test "
                f"phases done")
            phase_gpu_vs_cpu(params, ModelConfig(dtype="float32"))
        finally:
            shutil.rmtree(work, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
