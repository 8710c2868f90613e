"""utils.debug NaN guards."""

import numpy as np
import pytest
import jax.numpy as jnp

from ssnt_tts.utils import debug


def test_guard_nans_passes_clean():
    f = debug.guard_nans(lambda x: x * 2, "double")
    err, out = f(jnp.ones(4))
    err.throw()
    np.testing.assert_array_equal(np.asarray(out), 2.0)


def test_guard_nans_catches():
    f = debug.guard_nans(lambda x: jnp.log(x), "log")
    err, out = f(jnp.asarray([-1.0]))
    with pytest.raises(Exception):
        err.throw()


def test_tree_nan_report():
    tree = {"a": np.ones(3), "b": np.array([1.0, np.nan, np.inf])}
    rep = debug.tree_nan_report(tree)
    assert len(rep) == 1
    assert list(rep.values()) == [2]
