"""The plain reference against a small float64 CPU run of the port's own
entry points, on the same seeded inputs."""

import numpy as np
import pytest
import torch

from gpbench.reference import gp as ref
from gpbench.synth import make_data, uniform_rows

N, D = 256, 24
F64 = "float64"


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


@pytest.fixture(scope="module")
def fitted():
    from gp_tpu_torch import GP
    X, y = make_data(N + 40, D, (5, 1))
    gp = GP(X[:N], y[:N], device="cpu")
    gp._MAX_EVAL = 30
    nll = gp.train()
    return gp, X[:N], y[:N], X[N:], nll


def test_nll_and_default_start(fitted):
    gp, X, y, _, nll = fitted
    h = _t(gp.get_hyp())
    assert ref.nll(_t(X), _t(y), h, F64) == pytest.approx(nll, rel=1e-10)
    h0 = ref.default_hyp(_t(X), _t(y))
    np.testing.assert_allclose(h0.numpy(), gp.get_default_hyps(), rtol=1e-12)


def test_gradient_matches_the_objective(fitted):
    gp, X, y, _, _ = fitted
    x = gp.last_opt_result.x
    f, g = gp._objective_closure()(x)
    ys, _, _ = ref.standardized(_t(y))
    f_ref, g_ref = ref.nll_grad(_t(X), ys, x.double(), F64)
    assert f_ref == pytest.approx(float(f), rel=1e-10)
    np.testing.assert_allclose(g_ref.numpy(), g.numpy(), rtol=1e-7,
                               atol=1e-8 * float(g.abs().max()))


def test_predictions_and_input_gradients(fitted):
    gp, X, y, Xte, _ = fitted
    h = _t(gp.get_hyp())
    _, L, alpha = ref.posterior(_t(X), _t(y), h, F64)
    mu, s2 = ref.predict(_t(X), h, L, alpha, _t(Xte), F64)
    pmu, ps2 = gp.batch_predict(Xte)
    np.testing.assert_allclose(mu.numpy(), pmu.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(s2.numpy(), ps2.numpy(), rtol=1e-9, atol=1e-12)
    got = ref.predict_with_grad(_t(X), h, L, alpha, _t(Xte), F64)
    want = (*gp.batch_predict_y_with_grad(Xte),
            *gp.batch_predict_s2_with_grad(Xte))
    for a, b in zip(got, (want[0], want[1], want[2], want[3])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8,
                                   atol=1e-10 * float(b.abs().max()))


def test_absorbed_posterior(fitted):
    from gp_tpu_torch import BucketedGP
    gp, X, y, Xte, _ = fitted
    h = gp.get_hyp()
    bo = BucketedGP(X[:200], y[:200], bucket=32, device="cpu")
    bo.set_fixed(True)
    bo.train(init_hyps=h)
    for i in range(200, 224):
        bo.absorb(X[i], y[i])
    _, L, alpha = ref.posterior(_t(X[:224]), _t(y[:224]), _t(h), F64)
    got = ref.predict_with_grad(_t(X[:224]), _t(h), L, alpha, _t(Xte), F64)
    want = (*bo.batch_predict_y_with_grad(Xte),
            *bo.batch_predict_s2_with_grad(Xte))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-7,
                                   atol=1e-9 * float(b.abs().max()))


def test_stream_posterior(monkeypatch):
    from gp_tpu_torch import GP
    from gp_tpu_torch.models import exact
    monkeypatch.setattr(exact, "_STREAM_MIN_N", 64)
    X, y = make_data(150, 10, (6, 0))
    h = np.array([0.4] * 10 + [0.2, -1.9, -0.1])
    gp = GP(X, y, device="cpu")
    gp.set_fixed(True)
    gp.train(init_hyps=h)
    assert gp._factor_free()
    Xq = uniform_rows(20, 10, (6, 2))
    _, L, alpha = ref.posterior(_t(X), _t(y), _t(h), F64)
    mu, s2 = ref.predict(_t(X), _t(h), L, alpha, _t(Xq), F64)
    pmu, ps2 = gp.batch_predict(Xq)
    np.testing.assert_allclose(mu.numpy(), pmu.numpy(), rtol=1e-9)
    np.testing.assert_allclose(s2.numpy(), ps2.numpy(), rtol=1e-9)


def test_tf32_rounding():
    a = torch.randn(4096, dtype=torch.float32) * 1e3
    r = ref.round_tf32(a)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
    assert float(((r - a).abs() / a.abs()).max()) <= 2.0 ** -11
    assert float(((r - a).abs() / a.abs()).max()) > 2.0 ** -14


def test_box_and_standardized_units(fitted):
    gp, X, y, _, _ = fitted
    x, yv = _t(X), _t(y)
    lb, ub = ref.hyp_bounds(x, yv)
    plb, pub = gp.hyp_bounds()
    np.testing.assert_allclose(lb.numpy(), plb, rtol=1e-12)
    np.testing.assert_allclose(ub.numpy(), pub, rtol=1e-12)
    _, mu, sigma = ref.standardized(yv)
    slb, sub = gp._std_bounds()
    np.testing.assert_allclose(ref.to_standardized(lb, mu, sigma).numpy(),
                               slb, rtol=1e-12)
    np.testing.assert_allclose(ref.to_standardized(ub, mu, sigma).numpy(),
                               sub, rtol=1e-12)
    h = _t(gp.get_hyp())
    back = ref.from_standardized(ref.to_standardized(h, mu, sigma), mu,
                                 sigma)
    np.testing.assert_allclose(back.numpy(), h.numpy(), rtol=1e-12)
