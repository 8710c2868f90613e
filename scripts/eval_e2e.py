"""BASELINE config-3 end-to-end eval artifact (VERDICT r2 #5; r4 #2/#3).

Round-5 shape: training batches flow through the data_files.py bucketed
.npz-shard pipeline (materialize_synthetic -> NpzShardDataset.batches,
padding stats recorded; the eval batch comes from the generator directly
because the teacher-forced metric needs its `alignment` field), the
duration head trains with the duration-lattice marginal NLL
(ModelConfig.use_duration_lattice — the calibration fix the r4 empty-beam
triage prescribed), the eval runs at N >= 256 with the emptied-rate's
binomial stderr, and the v2 decode is evaluated BOTH at reference
defaults and with V2BeamConfig.final_feasible_guard (the round-5
remedy).

One re-runnable script: synthetic corpus -> N training steps at B=256 ->
  - train_step_ms (median of block_until_ready-timed steps, GPU only),
  - teacher-forced mel reconstruction error (frame joint along the TRUE
    alignment vs ground-truth mel),
  - v2_duration_decode -> upsample -> synthesize_from_alignment -> decoded
    mel error vs ground truth (the full production pipeline, SURVEY §3.1+3.3)
    + beam_emptied rate,
  - tone_decode -> levenshtein_edit_distance vs tone targets (the
    reference's one eval metric, /root/reference/src/edit_distance.rs:6-24).

Writes the record as JSON to --out (also printed to stdout).

  python -u scripts/eval_e2e.py --steps 150 --out chiprun_out/eval.json
  python -u scripts/eval_e2e.py --cpu --tiny --steps 8   # smoke
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--eval-batch", type=int, default=256)
    p.add_argument("--beam", type=int, default=8)
    p.add_argument("--corpus", type=int, default=4096,
                   help="examples materialized into .npz shards")
    p.add_argument("--data-dir", type=str, default="build/eval_shards")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    import jax.numpy as jnp
    import numpy as np

    from ssnt_tts import data as data_lib
    from ssnt_tts import data_files as data_files_lib
    from ssnt_tts.models import SSNTModel
    from ssnt_tts.ops import edit_distance
    from ssnt_tts.parallel import decode as decode_lib
    from ssnt_tts.parallel import train as train_lib
    from ssnt_tts.utils.config import (
        ModelConfig, TrainConfig, tiny_model_config,
    )
    from ssnt_tts.utils.profiling import time_call
    from ssnt_tts.utils.runtime import configure_compile_cache

    configure_compile_cache()

    t_start = time.time()
    if args.tiny:
        cfg = tiny_model_config(use_duration_lattice=True)
        T, U = 16, 40
    else:
        # use_duration_lattice: the round-5 duration-head calibration
        # (marginal NLL over the v2 alignment space trains the head to
        # land total durations on output_length — the empty-beam fix
        # the r4 triage prescribed).
        cfg = ModelConfig(
            vocab_size=128, mel_dim=80, encoder_dim=256, encoder_layers=2,
            encoder_heads=4, decoder_dim=256, joint_rank=64,
            use_duration_lattice=True,
        )
        T, U = 80, 400
    model = SSNTModel(cfg)
    ds = data_lib.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
        max_input_length=T, max_output_length=U,
        duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=0,
    )
    B = args.batch
    tcfg = TrainConfig(warmup_steps=max(2, args.steps // 10), batch_size=B,
                       learning_rate=3e-4)
    first = {k: v for k, v in ds.batch(B).items() if k != "alignment"}
    state = train_lib.init_train_state(
        model, jax.random.PRNGKey(0), first, tcfg
    )
    tx = train_lib.make_optimizer(tcfg)

    step = jax.jit(
        lambda s, b: train_lib.train_step(model, tx, s, b),
        donate_argnums=(0,),
    )

    # ---- materialize the corpus into .npz shards; train from them ----
    import shutil

    shutil.rmtree(args.data_dir, ignore_errors=True)
    n_corpus = 256 if args.tiny else args.corpus
    print(f"[eval] materializing {n_corpus} examples into "
          f"{args.data_dir}...", flush=True)
    data_files_lib.materialize_synthetic(ds, n_corpus, args.data_dir)
    file_ds = data_files_lib.NpzShardDataset(args.data_dir)
    stats = data_files_lib.PaddingStats()
    batch_iter = file_ds.batches(B, shuffle_seed=0, drop_remainder=False)

    print(f"[eval] training {args.steps} steps at B={B} from npz "
          f"shards ({len(file_ds)} examples, bucketed)...", flush=True)
    losses = []
    for i in range(args.steps):
        batch = next(batch_iter)
        stats.update(batch)
        state, metrics = step(state, batch)
        if (i + 1) % max(1, args.steps // 10) == 0:
            loss = float(np.asarray(metrics["loss"]))
            losses.append(loss)
            print(f"[eval] step {i+1}: loss {loss:.4f} "
                  f"(+{time.time()-t_start:.0f}s)", flush=True)

    record = {
        "config": "BASELINE-3 (B=256 train, 1 host)" if not args.tiny
        else "tiny-smoke",
        "batch": B,
        "steps": args.steps,
        "data_source": "npz_shards",
        "corpus_examples": len(file_ds),
        "padding_stats": stats.summary(),
        "device": jax.devices()[0].device_kind,
        "loss_first_logged": losses[0] if losses else None,
        "loss_final": losses[-1] if losses else None,
    }

    # ---- train-step timing at B=256 ----
    if not args.cpu:
        print("[eval] timing train step...", flush=True)
        bench_batch = {
            k: v for k, v in ds.batch(B).items() if k != "alignment"
        }

        step = jax.jit(lambda s, b: train_lib.train_step(model, tx, s, b))
        st = time_call(step, jax.device_get(state), bench_batch)
        record["train_step_ms"] = round(st["median_ms"], 3)
        record["train_examples_per_s"] = round(B / st["median_ms"] * 1e3, 1)

    # ---- eval batch ----
    Be = args.eval_batch
    ev = ds.batch(Be)
    tokens = jnp.asarray(ev["tokens"])
    il = jnp.asarray(ev["input_length"])
    ol = jnp.asarray(ev["output_length"])
    mel_true = np.asarray(ev["mel"])
    params = state.params

    enc = jax.jit(lambda p, t, l: model.apply(p, t, l, method=model.encode))(
        params, tokens, il
    )

    umask = (
        np.arange(U)[None, :] < np.asarray(ol)[:, None]
    )[..., None]  # (B, U, 1)

    # Teacher-forced mel reconstruction along the TRUE alignment.
    mel_tf = np.asarray(
        jax.jit(
            lambda p, e, a: model.apply(
                p, e, a, method=model.synthesize_from_alignment
            )
        )(params, enc, jnp.asarray(ev["alignment"]))
    )
    record["mel_l2_teacher_forced_alignment"] = round(
        float(np.sqrt((((mel_tf - mel_true) ** 2) * umask).sum()
                      / (umask.sum() * cfg.mel_dim))), 4
    )

    # v2 production decode -> alignment -> synthesis (SURVEY §3.1 + §3.3).
    # Two arms: reference-default constraints, and the round-5
    # final-feasibility guard (V2BeamConfig.final_feasible_guard).
    from ssnt_tts.utils.config import V2BeamConfig

    dur_table = jnp.arange(cfg.duration_class_size, dtype=jnp.int32)
    for arm, v2cfg in [
        ("", V2BeamConfig()),
        ("_guard", V2BeamConfig(final_feasible_guard=True)),
    ]:
        print(f"[eval] v2 duration decode (arm: default{arm})...",
              flush=True)
        v2 = jax.jit(
            lambda p, t, l, o, c=v2cfg: decode_lib.v2_duration_decode(
                model, p, t, l, o, dur_table,
                beam_width=args.beam, max_frames=U, config=c,
            )
        )(params, tokens, il, ol)
        best_src = v2["source_indexes"][:, 0, :]  # best beam (B, U)
        mel_dec = np.asarray(
            jax.jit(
                lambda p, e, a: model.apply(
                    p, e, a, method=model.synthesize_from_alignment
                )
            )(params, enc, best_src)
        )
        record[f"mel_l2_v2_decoded_alignment{arm}"] = round(
            float(np.sqrt((((mel_dec - mel_true) ** 2) * umask).sum()
                          / (umask.sum() * cfg.mel_dim))), 4
        )
        emptied = np.asarray(v2["beam_emptied"]).astype(np.float64)
        rate = float(emptied.mean())
        record[f"v2_beam_emptied_rate{arm}"] = round(rate, 4)
        record[f"v2_beam_emptied_stderr{arm}"] = round(
            float(np.sqrt(max(rate * (1 - rate), 1e-12) / len(emptied))),
            4,
        )
        # Duration fidelity of the decoded best beam.
        record[f"v2_output_length_mae_frames{arm}"] = round(
            float(np.abs(
                np.asarray(v2["output_length"])[:, 0] - np.asarray(ol)
            ).mean()), 2
        )
    record["eval_n"] = int(Be)

    # Tone decode -> edit distance vs targets (reference metric).
    print("[eval] tone decode + edit distance...", flush=True)
    td = jax.jit(
        lambda p, t, l: decode_lib.tone_decode(
            model, p, t, l, beam_width=args.beam
        )
    )(params, tokens, il)
    tones_best = td["tones"][:, 0, :]  # (B, T)
    dist = np.asarray(
        jax.jit(edit_distance.levenshtein_edit_distance)(
            tones_best, jnp.asarray(ev["tone_target"]), il, il
        )
    )
    record["tone_edit_distance_mean"] = round(float(dist.mean()), 3)
    record["tone_edit_distance_per_token"] = round(
        float((dist / np.asarray(il)).mean()), 4
    )
    record["wall_s"] = round(time.time() - t_start, 1)

    print(json.dumps(record))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
