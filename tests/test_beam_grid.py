"""The XLA beam steps against the numpy oracle over the randomized grid of
ssnt_tts/oracle/beam_grid.py: C > 128, -0.0/+0.0 ties, finished,
out-of-range and widened beams. `chip_smoke.py` runs the same grid on the
GPU."""

import pytest

from ssnt_tts.oracle import beam_grid


@pytest.mark.parametrize("kind,variant,seed", beam_grid.cases())
def test_batched_step_matches_oracle(kind, variant, seed):
    assert beam_grid.check(kind, variant, seed) == beam_grid._B


def test_wide_cases_exceed_128_candidates():
    for kind in beam_grid.KINDS:
        W, C = beam_grid._SHAPES[kind]["wide"]
        assert W * C > 128


def test_ties_case_holds_signed_zeros():
    import numpy as np

    case = beam_grid.make_case("v1", "ties", 0)
    lp = case["lp"]
    assert (np.signbit(lp) & (lp == 0)).any() and (~np.signbit(lp) & (lp == 0)).any()
