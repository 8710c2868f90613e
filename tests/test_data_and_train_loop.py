"""Data pipeline invariants + short end-to-end training run with
checkpoint/resume."""

import os

import numpy as np
import pytest

from ssnt_tts import data as data_lib


def test_synthetic_dataset_invariants():
    ds = data_lib.SyntheticTTSDataset(
        vocab_size=32, mel_dim=8, max_input_length=10, max_output_length=30,
        duration_class_size=5, tone_class_size=4,
    )
    b = ds.batch(4)
    assert b["tokens"].shape == (4, 10)
    assert b["mel"].shape == (4, 30, 8)
    for i in range(4):
        Tb = b["input_length"][i]
        Ub = b["output_length"][i]
        assert 0 < Ub <= 30
        # durations of real positions sum to the output length
        assert b["duration_target"][i, :Tb].sum() >= Tb  # clipped classes
        a = b["alignment"][i, :Ub]
        assert a[0] == 0
        assert ((np.diff(a) >= 0) & (np.diff(a) <= 1)).all()
        assert a.max() == Tb - 1  # alignment covers all tokens


def test_prefetch_to_device():
    ds = data_lib.SyntheticTTSDataset(
        vocab_size=16, mel_dim=4, max_input_length=6, max_output_length=12
    )
    it = iter([ds.batch(2), ds.batch(2)])
    out = list(data_lib.prefetch_to_device(it))
    assert len(out) == 2
    assert out[0]["tokens"].shape == (2, 6)


def test_training_loop_runs_and_resumes(tmp_path):
    from ssnt_tts.train_loop import run_training
    from ssnt_tts.utils.config import (
        MeshConfig,
        TrainConfig,
        tiny_model_config,
    )

    ckpt = str(tmp_path / "ckpt")
    kwargs = dict(
        model_config=tiny_model_config(),
        train_config=TrainConfig(
            warmup_steps=2, batch_size=4, max_input_length=6,
            max_output_length=12,
        ),
        mesh_config=MeshConfig(data=1, model=1),
        checkpoint_dir=ckpt,
        checkpoint_every=3,
        log_every=2,
    )
    m1 = run_training(num_steps=3, **kwargs)
    assert np.isfinite(m1["loss"])
    from ssnt_tts.utils import checkpoint as ckpt_lib

    assert ckpt_lib.latest_step(ckpt) == 3
    # Resume continues from step 3.
    m2 = run_training(num_steps=5, **kwargs)
    assert np.isfinite(m2["loss"])
    assert ckpt_lib.latest_step(ckpt) == 5
