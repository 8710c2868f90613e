"""Triage of the v2 empty-beam rate (VERDICT r3 #4).

An end-to-end evaluation measured v2_beam_emptied_rate = 0.0625 at BASELINE config-3
scale (B=256 train, 150 steps) — 1 in 16 utterances hits the condition
where the reference panics (src/v2.rs:292). This script answers WHY:

  1. which prune empties the beam (collect_diagnostics: per-utterance
     [band, overrun, exact_final, zero_skip] rescue counts at the first
     emptying step + the source position where it happened),
  2. whether longer training drives it down (checkpoints of the SAME run
     at increasing step counts),
  3. whether allow_skip or a wider diagonal band eliminates it
     (config sweep at the final checkpoint).

Writes the record as JSON to --out.

  python -u scripts/triage_empty_beam.py --out chiprun_out/triage.json
  python -u scripts/triage_empty_beam.py --cpu --tiny --steps 8  # smoke
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, nargs="+", default=[150, 400, 800])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--eval-batch", type=int, default=64)
    p.add_argument("--beam", type=int, default=8)
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
    from ssnt_tts.models import SSNTModel
    from ssnt_tts.parallel import decode as decode_lib
    from ssnt_tts.parallel import train as train_lib
    from ssnt_tts.utils.config import (
        ModelConfig, TrainConfig, V2BeamConfig, tiny_model_config,
    )

    t0 = time.time()
    if args.tiny:
        cfg = tiny_model_config()
        T, U = 16, 40
    else:
        cfg = ModelConfig(
            vocab_size=128, mel_dim=80, encoder_dim=256, encoder_layers=2,
            encoder_heads=4, decoder_dim=256, joint_rank=64,
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
    total_steps = max(args.steps)
    tcfg = TrainConfig(warmup_steps=max(2, total_steps // 10),
                       batch_size=B, learning_rate=3e-4)
    first = {k: v for k, v in ds.batch(B).items() if k != "alignment"}
    state = train_lib.init_train_state(
        model, jax.random.PRNGKey(0), first, tcfg
    )
    tx = train_lib.make_optimizer(tcfg)
    step = jax.jit(
        lambda s, b: train_lib.train_step(model, tx, s, b),
        donate_argnums=(0,),
    )

    Be = args.eval_batch
    ev = ds.batch(Be)
    tokens = jnp.asarray(ev["tokens"])
    il = jnp.asarray(ev["input_length"])
    ol = jnp.asarray(ev["output_length"])
    dtab = jnp.asarray(cfg.duration_table, jnp.int32)

    def run_decode(params, allow_skip=False, config=None, beam=None):
        out = jax.jit(
            lambda p: decode_lib.v2_duration_decode(
                model, p, tokens, il, ol, dtab,
                beam_width=beam or args.beam, max_frames=U,
                allow_skip=allow_skip, collect_diagnostics=True,
                config=config,
            )
        )(params)
        emptied = np.asarray(out["beam_emptied"])
        counts = np.asarray(out["first_empty_prune_counts"])  # (B, 4)
        ft = np.asarray(out["first_empty_t"])
        olen_mae = float(
            np.abs(
                np.asarray(out["output_length"][:, 0]) - np.asarray(ol)
            ).mean()
        )
        e = emptied.astype(bool)
        names = ["band", "overrun", "exact_final", "zero_skip"]
        # Among emptied utterances: which single relaxation would have
        # kept >=1 candidate alive at the first emptying step.
        rescue = {
            n: int((counts[e, i] > 0).sum()) for i, n in enumerate(names)
        }
        rel_pos = (
            (ft[e] / np.maximum(np.asarray(il)[e] - 1, 1)).tolist()
            if e.any() else []
        )
        return {
            "emptied_rate": round(float(e.mean()), 4),
            "n_emptied": int(e.sum()),
            "rescued_by": rescue,
            "first_empty_t_relative": [round(x, 3) for x in rel_pos],
            "output_length_mae_frames": round(olen_mae, 2),
        }

    record = {
        "eval_batch": Be,
        "beam": args.beam,
        "train_batch": B,
        "checkpoints": {},
        "sweeps_at_final": {},
    }
    done = 0
    for target in sorted(args.steps):
        for _ in range(target - done):
            batch = {
                k: v for k, v in ds.batch(B).items() if k != "alignment"
            }
            state, metrics = step(state, batch)
        done = target
        loss = float(np.asarray(metrics["loss"]))
        r = run_decode(state.params)
        r["loss"] = round(loss, 3)
        record["checkpoints"][str(target)] = r
        print(f"[triage] steps={target} loss={loss:.3f} -> {r}",
              flush=True)

    # Config sweeps at the final checkpoint.
    sweeps = {
        "allow_skip": dict(allow_skip=True),
        "band_x2": dict(
            config=V2BeamConfig(band_upper_frac=0.2, band_lower_frac=0.1)
        ),
        "band_x4": dict(
            config=V2BeamConfig(band_upper_frac=0.4, band_lower_frac=0.2)
        ),
        # Beam capacity: emptying is a duration-diversity question (the
        # beam must CARRY a hypothesis whose cumulative duration can land
        # exactly on output_length at t = T-1).
        "beam_x2": dict(beam=2 * args.beam),
        "beam_x4": dict(beam=4 * args.beam),
    }
    for name, kw in sweeps.items():
        r = run_decode(state.params, **kw)
        record["sweeps_at_final"][name] = r
        print(f"[triage] sweep {name} -> {r}", flush=True)

    record["wall_s"] = round(time.time() - t0, 1)
    out = json.dumps(record, indent=1)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)


if __name__ == "__main__":
    main()
