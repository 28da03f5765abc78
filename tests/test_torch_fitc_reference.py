"""The port's FITC against the benchmark's plain float64 reference
(gpbench/reference/fitc.py) on seeded random rows, on the CPU: the NLL,
the optimizer's value and gradient, the posterior's predictions and a
capped train()'s final NLL.  The inducing rows are the last M, as the
upstream's fitc demo takes them.

The two compute the same function in different forms: the port in
FITC.cpp's, log|A| - log|Kuu| with A = sn2 Kuu + Kux Gamma^-1 Kxu, the
reference in the whitened one.  The port's form rounds to about
eps cond(A) of the NLL, and Gamma = 1 + (sf2 - qdiag) / sn2 divides a
cancellation of size eps sf2 by sn2 on each of the M inducing rows, where
the residual is the jitter alone.  At the library's start with d = 3
(sn = 1e-3, cond(A) = 7e7) the port's NLL is 3.6e-8 of itself off an
80-bit evaluation and the reference's 1e-13.  So each comparison is held
to 16 eps (cond(A) + M sf2 / sn2) of its size (`_scale`)."""

import numpy as np
import pytest
import torch

from gp_tpu_torch import FITC
from gp_tpu_torch.models import fitc
from gpbench.reference import fitc as ref

EPS = float(np.finfo(np.float64).eps)

# (N, M, d): the deployment's d = 90 and a low d at which every length
# scale shapes the NLL
CASES = [(500, 48, 3), (420, 32, 90)]


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (n + 40, d))
    y = (np.sin(2.0 * X[:, 0]) + 0.5 * np.cos(3.0 * X[:, 1])
         + 0.1 * rng.standard_normal(n + 40))
    return X[:n], y[:n], X[n:]


def _model(n, m, d, seed=0):
    X, y, Xte = _data(n, d, seed)
    gp = FITC(X, y, device="cpu")
    gp.set_inducing(X[-m:])
    return gp, torch.as_tensor(X), torch.as_tensor(y), torch.as_tensor(Xte)


def _points(gp, d):
    """The library's start, and a point off it: the length scales
    stretched (at d = 90 the start's covariances vanish, e^-90 between
    rows), the noise raised, every entry moved a little."""
    h0 = gp.get_default_hyps()
    h1 = h0.copy()
    h1[:d] += 1.5 if d > 10 else 0.3
    h1[d + 1] = np.log(0.2)
    h1 += 0.05 * np.random.default_rng(1).standard_normal(h1.shape)
    return [h0, h1]


def _scale(gp, h, x, u):
    """cond(A) + M sf2 / sn2 at h, A as the port forms it (on the rows'
    device; tests/test_torch_fitc_golden.py uses it too)."""
    d, m = x.shape[1], u.shape[0]
    ht = torch.as_tensor(np.asarray(h, np.float64), device=x.device)
    sf2, sn2 = np.exp(2.0 * h[d]), np.exp(2.0 * h[d + 1])
    Kuu = gp.kernel.k(ht[:d + 1], u, u) + ref.JITTER * torch.eye(
        m, dtype=x.dtype, device=x.device)
    Kxu = gp.kernel.k(ht[:d + 1], x, u)
    V = torch.linalg.solve_triangular(torch.linalg.cholesky(Kuu), Kxu.T,
                                      upper=False)
    gamma = 1.0 + torch.clamp(sf2 - (V * V).sum(0), min=0.0) / sn2
    A = sn2 * Kuu + (Kxu.T / gamma) @ Kxu
    return float(torch.linalg.cond(A)) + m * sf2 / sn2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("n,m,d", CASES)
def test_nll_and_objective_value_and_gradient(n, m, d):
    gp, x, y, _ = _model(n, m, d)
    u = x[-m:]
    jit = torch.tensor(ref.JITTER, dtype=torch.float64)
    closure = gp._objective_closure()
    jit_std = ref.JITTER / gp._y_sigma ** 2
    for h in _points(gp, d):
        tol = 16 * EPS * _scale(gp, h, x, u)
        ht = torch.as_tensor(h)
        port = float(fitc.nll_raw(gp.kernel, ht, x, y, u, jit))
        want = ref.nll(x, y, ht, u)
        assert abs(port - want) <= tol * abs(want)
        v = torch.as_tensor(gp._hyp_to_std(h))
        f, g = closure(v)
        f_ref, g_ref = ref.nll_grad(x, gp._ys, v, u, jit_std)
        assert abs(float(f) - f_ref) <= tol * abs(f_ref)
        assert _rel(g, g_ref) <= tol
        # the standardized units shift the NLL by N log sigma_y
        assert abs(f_ref + n * np.log(gp._y_sigma) - want) <= (
            tol * abs(want))


@pytest.mark.parametrize("n,m,d", CASES)
def test_posterior_mean_and_variance(n, m, d):
    gp, x, y, xte = _model(n, m, d)
    h = _points(gp, d)[1]
    gp.set_fixed(True)
    gp.train(init_hyps=h)
    mu, s2 = gp.batch_predict(xte)
    post = ref.posterior(x, y, torch.as_tensor(h), x[-m:])
    mu_ref, s2_ref = ref.predict(post, xte)
    assert post.jitter == gp._jitter_u == ref.JITTER
    tol = 16 * EPS * _scale(gp, h, x, x[-m:])
    assert _rel(mu, mu_ref) <= tol
    assert _rel(s2, s2_ref) <= tol
    # off the inducing rows the variance stays above the noise
    assert bool((s2_ref > torch.exp(2.0 * torch.as_tensor(h[-2]))).any())


@pytest.mark.parametrize("n,m,d", CASES[:1])
def test_capped_train_final_nll(n, m, d):
    gp, x, y, _ = _model(n, m, d, seed=2)
    gp._MAX_EVAL = 12
    nll = gp.train()
    h = torch.as_tensor(gp.get_hyp())
    assert gp.last_opt_result.evals <= 12
    assert ref.nll(x, y, h, x[-m:]) < ref.nll(
        x, y, torch.as_tensor(gp.get_default_hyps()), x[-m:])
    tol = 16 * EPS * _scale(gp, gp.get_hyp(), x, x[-m:])
    # train()'s value is the NLL at the jitter its final posterior kept
    assert abs(nll - ref.train_nll(x, y, h, x[-m:])) <= tol * abs(nll)


def test_train_value_at_the_jitter_the_posterior_kept():
    """Where the final posterior doubles the jitter (long length scales:
    A from the raw Kuu is not SPD on the first try), train() returns the
    NLL at the doubled jitter, FITC::_setK's: ref.train_nll.  The rounding
    bound above is no use here (cond(A) ~ 1e14), so the value is held
    nearer train_nll than the NLL at the first jitter by 1000x."""
    n, m, d = CASES[0]
    gp, x, y, _ = _model(n, m, d)
    h = gp.get_default_hyps().copy()
    h[:d], h[d + 1] = 2.5, -3.0
    gp.set_fixed(True)
    v = gp.train(init_hyps=h)
    assert gp._jitter_u == 2 * ref.JITTER
    ht, u = torch.as_tensor(h), x[-m:]
    assert abs(v - ref.train_nll(x, y, ht, u)) <= 1e-3 * abs(
        v - ref.nll(x, y, ht, u))
