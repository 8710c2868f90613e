"""The .npz checkpoint format: round trip, latest step, retention and
template checks."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ssnt_tts.parallel.train import TrainState
from ssnt_tts.utils import checkpoint as ckpt


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return TrainState(
        step=jnp.asarray(7, jnp.int32),
        params={
            "dense": {"kernel": jnp.asarray(rng.normal(size=(3, 4)),
                                            jnp.float32)},
            "scalar": jnp.asarray(0.5, jnp.float32),
            "half": jnp.asarray(rng.normal(size=(5,)), jnp.bfloat16),
        },
        opt_state=(jnp.asarray(rng.integers(0, 9, (2,)), jnp.int32), ()),
    )


def test_round_trip_keeps_values_dtypes_and_structure(tmp_path):
    state = _state()
    ckpt.save(str(tmp_path), 7, state)
    back = ckpt.restore(str(tmp_path), _state(seed=1))
    assert jax.tree.structure(back) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_latest_step_and_retention(tmp_path):
    d = str(tmp_path / "run")
    assert ckpt.latest_step(d) is None
    for step in (1, 2, 3, 4):
        ckpt.save(d, step, _state(step), max_to_keep=2)
    assert ckpt.latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["ckpt_0000000003.npz",
                                     "ckpt_0000000004.npz"]
    older = ckpt.restore(d, _state(), step=3)
    np.testing.assert_array_equal(
        np.asarray(older.params["dense"]["kernel"]),
        np.asarray(_state(3).params["dense"]["kernel"]))


def test_restore_rejects_a_different_template(tmp_path):
    ckpt.save(str(tmp_path), 1, _state())
    other = _state()
    other.params["extra"] = jnp.zeros((2,))
    with pytest.raises(ValueError, match="extra"):
        ckpt.restore(str(tmp_path), other)
    shaped = _state()
    shaped.params["scalar"] = jnp.zeros((2,))
    with pytest.raises(ValueError, match="scalar"):
        ckpt.restore(str(tmp_path), shaped)


def test_restore_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), _state())
