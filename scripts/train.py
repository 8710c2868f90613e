#!/usr/bin/env python
"""CLI training entry point (synthetic data).

  python scripts/train.py --steps 200 --batch-size 32 --ckpt build/ckpt
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--input-length", type=int, default=80)
    p.add_argument("--output-length", type=int, default=400)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--metrics", type=str, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model config (CI/smoke)")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend")
    args = p.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from ssnt_tts.train_loop import run_training
    from ssnt_tts.utils.runtime import configure_compile_cache
    from ssnt_tts.utils.config import (
        ModelConfig,
        TrainConfig,
        tiny_model_config,
    )

    configure_compile_cache()
    mcfg = tiny_model_config() if args.tiny else ModelConfig()
    tcfg = TrainConfig(
        learning_rate=args.lr,
        batch_size=args.batch_size,
        max_input_length=args.input_length,
        max_output_length=args.output_length,
        warmup_steps=min(1000, max(2, args.steps // 10)),
    )
    metrics = run_training(
        num_steps=args.steps,
        model_config=mcfg,
        train_config=tcfg,
        checkpoint_dir=args.ckpt,
        metrics_path=args.metrics,
    )
    print("final:", metrics)
    return 0


if __name__ == "__main__":
    sys.exit(main())
