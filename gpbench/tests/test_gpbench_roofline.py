"""roofline.py pinned to the bounds PERF.md's kernel table holds."""

import pytest

from gpbench import roofline


@pytest.mark.parametrize("m, d, ms", [(51200, 10, 3.13), (8000, 24, 0.0767)])
def test_k1_bound_matches_the_kernel_table(m, d, ms):
    bound, by = roofline.se_bound_ms(m, m, d, "float32", True)
    assert by == "bytes"
    assert bound == pytest.approx(ms, abs=0.005 if m > 10000 else 5e-5)


def test_k3_bound_at_the_leaf():
    bound, by = roofline.chol_bound_ms(128, "float32", True)
    assert by == "bytes" and bound == pytest.approx(4.90e-5, rel=0.01)


def test_model_flops():
    # an evaluation at N = 8000, d = 24 is N^3 and O(N^2 d) besides
    f = roofline.fit_eval_flops(8000, 24)
    assert 8000 ** 3 < f < 1.03 * 8000 ** 3
    # a 51200-row request that refactors is its factor (N^3 / 3) and one
    # solve (N^2 m); from a cached factor, the solve
    f = roofline.predict_request_flops(51200, 10, 2000, refactors=True)
    assert f == pytest.approx(51200 ** 3 / 3 + 51200 ** 2 * 2000, rel=0.01)
    f = roofline.predict_request_flops(8000, 24, 2000, refactors=False)
    assert f == pytest.approx(8000 ** 2 * 2000, rel=0.03)
