"""The generator's inputs are a function of the seed alone, and the fit
cell gives every seed the same set of fits, in another order."""

import numpy as np
import pytest

from gpbench import loops
from gpbench.harness import Run
from gpbench.synth import make_data, uniform_rows

BIG = 2 ** 33 + 17
FIT = {"heldout": 5, "pool": 6, "pool_seed": 1}


def _run(seed, traffic=FIT):
    return Run("x", {}, {"n": 40, "d": 24}, dict(traffic), seed, 1.0,
               False, None)


@pytest.mark.parametrize("seed", [0, 12345, BIG])
def test_same_seed_same_inputs(seed):
    a, b = loops.FitLoop(_run(seed), None), loops.FitLoop(_run(seed), None)
    np.testing.assert_array_equal(a.order(3), b.order(3))
    for x, y in zip(a.data(0, loops.WARM), b.data(0, loops.WARM)):
        np.testing.assert_array_equal(x, y)
    tr = {"rows": 7}
    qa = loops.PredictLoop(_run(seed, tr), None).query(loops.QUERY, 4)
    qb = loops.PredictLoop(_run(seed, tr), None).query(loops.QUERY, 4)
    np.testing.assert_array_equal(qa, qb)


def test_every_seed_fits_the_same_pool_in_another_order():
    a, b = loops.FitLoop(_run(BIG), None), loops.FitLoop(_run(BIG + 1), None)
    for j in range(FIT["pool"]):
        np.testing.assert_array_equal(a.data(j)[0], b.data(j)[0])
    assert sorted(a.order(0)) == list(range(FIT["pool"]))
    assert any(not np.array_equal(a.order(p), b.order(p)) for p in range(3))
    assert not np.array_equal(a.data(0)[0], a.data(1)[0])


def test_seeds_draw_apart():
    tr = {"rows": 7}
    qa = loops.PredictLoop(_run(BIG, tr), None).query(loops.QUERY, 0)
    qb = loops.PredictLoop(_run(BIG + 1, tr), None).query(loops.QUERY, 0)
    qc = loops.PredictLoop(_run(BIG, tr), None).query(loops.QUERY, 1)
    assert not np.array_equal(qa, qb) and not np.array_equal(qa, qc)


def test_streams_are_keyed_by_tag():
    s = loops.stream(_run(BIG), loops.EPISODE, 2, loops.CAND)
    assert s == (BIG, loops.EPISODE, 2, loops.CAND)
    np.testing.assert_array_equal(uniform_rows(4, 3, s), uniform_rows(4, 3, s))
    X, y = make_data(50, 10, s)
    assert X.shape == (50, 10) and np.all(np.abs(X) <= 2.0)
