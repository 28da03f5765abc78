"""gp_tpu_torch's exact GP with the Matern and RQ kernels against gp_tpu's,
on the CPU in float64.

These specs have no structured gradient contraction, so the objective
takes the generic branch: Q = K^-1 - alpha alpha^T and the vjp of the K1
build at Q (gp_tpu exact.py:203-209).

Tolerances and why:
- NLL at rtol 1e-10 and gradient at rtol 1e-7: the bounds
  tests/test_golden.py holds gp_tpu to;
- predictions at the same hyps: rtol 1e-9 (LAPACK's inverse against
  gp_tpu's factor-and-solve on a well-conditioned posterior);
- the fits: the two optimizers run the same algorithm on objectives that
  differ in the last bits, so their evaluation points agree to 1e-10
  for the first 30 evaluations (pinned below at 1e-8), then part by
  ~10x per few evaluations.  On the two problems used, both fits stop
  with no acceptable step after the same number of evaluations, at the
  end NLLs the tests hold: Matern-5/2 at rtol 1e-6 and hyps at atol 1e-4 (as
  tests/test_torch_exact.py holds SE), RQ at rtol 5e-5 and hyps at atol
  1e-4 (its log alpha is a flat direction, and the end NLLs came out
  5e-6 to 1.4e-5 apart at 1, 2 and 8 threads).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_tpu
from gp_tpu.models import exact as je
from gp_tpu.optim.lbfgsb import lbfgsb_impl as j_lbfgsb
from gp_tpu_torch import GP as TGP
from gp_tpu_torch.models import exact as te
from gp_tpu_torch.ops import kernels as tk
from gp_tpu_torch.optim.lbfgsb import lbfgsb_impl
from gp_tpu_torch.utils.convert import gp_from_state

NAMES = ["matern52", "matern52_iso", "matern32", "matern32_iso", "rq",
         "rq_iso"]
# problems (d, seed, noise) on which both fits stop after the same number
# of evaluations
FITS = {"matern52": (3, 7, 0.15), "rq": (5, 11, 0.1)}


def _problem(n=300, d=5, seed=0, noise=0.1):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, d))
    y = (np.sin(2 * X[:, 0]) + 0.5 * np.cos(3 * X[:, 1])
         + 0.3 * X[:, 2] * X[:, -1] + noise * rng.standard_normal(n))
    return X, y


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _n(t):
    return t.detach().cpu().numpy()


def _pair(kernel, X, y):
    return (gp_tpu.GP(X, y, kernel=kernel),
            TGP(X, y, kernel=kernel, device="cpu"))


def _hyp(gj, rng, shift=0.3):
    h = np.asarray(gj.get_default_hyps(), np.float64)
    h = h + rng.uniform(-shift, shift, h.shape)
    h[-2] = np.log(0.1)                # a well-conditioned K
    return h


@pytest.mark.parametrize("kernel", NAMES)
def test_nll_and_gradient_match(kernel):
    X, y = _problem(n=150, d=4, seed=3)
    gj, gt = _pair(kernel, X, y)
    hyp = _hyp(gj, np.random.default_rng(0))
    if kernel.startswith("rq"):
        hyp[-3] = np.log(2.5)          # off-default alpha
    vj = je.nll(gj.kernel, jnp.asarray(hyp), gj._x, gj._y)
    vt = te.nll(gt.kernel, _t(hyp), gt._x, gt._y)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-10)
    fj, g_j = je.nll_vg_raw(gj.kernel, jnp.asarray(hyp), gj._x, gj._y)
    ft, g_t = te.nll_vg_raw(gt.kernel, _t(hyp), gt._x, gt._y)
    assert not g_t.requires_grad and not ft.requires_grad
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-10)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(_n(g_t), g_j, rtol=1e-7,
                               atol=1e-7 * np.max(np.abs(g_j)))
    vec = gj._hyp_to_std(hyp)
    oj = je.objective_vg(gj.kernel, False, jnp.asarray(vec), gj._x, gj._ys)
    ot = te.objective_vg(gt.kernel, False, _t(vec), gt._x, gt._ys)
    np.testing.assert_allclose(float(ot[0]), float(oj[0]), rtol=1e-10)
    np.testing.assert_allclose(_n(ot[1]), np.asarray(oj[1]), rtol=1e-7,
                               atol=1e-7 * np.max(np.abs(oj[1])))


@pytest.mark.parametrize("kernel", ["se_ard", "se_iso"])
def test_generic_gradient_branch_matches_the_structured_one(kernel):
    """The SE specs without their structured contraction take the
    generic branch: the same NLL and gradient."""
    X, y = _problem(n=120, d=3, seed=2)
    spec = tk.get_kernel(kernel)
    generic = spec._replace(k_noise_vjp_q=None)
    hyp = _hyp(gp_tpu.GP(X, y, kernel=kernel), np.random.default_rng(1))
    f0, g0 = te.nll_vg_raw(spec, _t(hyp), _t(X), _t(y))
    f1, g1 = te.nll_vg_raw(generic, _t(hyp), _t(X), _t(y))
    np.testing.assert_allclose(float(f1), float(f0), rtol=1e-12)
    np.testing.assert_allclose(_n(g1), _n(g0), rtol=1e-9,
                               atol=1e-9 * float(g0.abs().max()))


@pytest.mark.parametrize("kernel", sorted(FITS))
def test_lbfgsb_first_30_evaluations_match(kernel):
    d, seed, noise = FITS[kernel]
    X, y = _problem(d=d, seed=seed, noise=noise)
    gj, gt = _pair(kernel, X, y)
    lb, ub = gj._std_bounds()
    x0 = np.clip(gj._hyp_to_std(gj.get_default_hyps()), lb, ub)
    fj = lambda v: je.objective_vg(gj.kernel, False, v, gj._x, gj._ys)
    rj = jax.jit(lambda v: j_lbfgsb(fj, v, jnp.asarray(lb), jnp.asarray(ub),
                                    max_evals=30))(jnp.asarray(x0))
    ft = lambda v: te.objective_vg(gt.kernel, False, v, gt._x, gt._ys)
    rt = lbfgsb_impl(ft, _t(x0), _t(lb), _t(ub), max_evals=30)
    assert rt.evals == int(rj.evals)
    np.testing.assert_allclose(_n(rt.x), np.asarray(rj.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(float(rt.f), float(rj.f), rtol=1e-9)


@pytest.fixture(scope="module", params=sorted(FITS))
def trained(request):
    kernel = request.param
    d, seed, noise = FITS[kernel]
    X, y = _problem(d=d, seed=seed, noise=noise)
    gj, gt = _pair(kernel, X, y)
    Xs = _problem(n=40, d=d, seed=9)[0]
    return kernel, gj, gt, gj.train(), gt.train(), Xs


def test_train_matches_gp_tpu(trained):
    kernel, gj, gt, vj, vt, _ = trained
    assert gt.last_opt_result.evals == int(gj.last_opt_result.evals)
    np.testing.assert_allclose(vt, vj,
                               rtol=1e-6 if kernel == "matern52" else 5e-5)
    np.testing.assert_allclose(gt.get_hyp(), np.asarray(gj.get_hyp()),
                               atol=1e-4)
    assert not np.allclose(gt.get_hyp(), gt.get_default_hyps())


def test_predictions_at_the_fitted_hyps_match_gp_tpu(trained):
    """Every prediction entry point, the port's posterior built by
    gp_from_state at gp_tpu's fitted hyps."""
    kernel, gj, _, _, _, Xs = trained
    gt = gp_from_state({"x": np.asarray(gj._x), "y": np.asarray(gj._y),
                        "hyps": np.asarray(gj.get_hyp()), "kernel": kernel},
                       device="cpu")
    for name in ("batch_predict", "batch_predict_y", "batch_predict_s2",
                 "batch_predict_y_with_grad", "batch_predict_s2_with_grad"):
        oj, ot = getattr(gj, name)(Xs), getattr(gt, name)(Xs)
        for a, b in zip(ot if isinstance(ot, tuple) else (ot,),
                        oj if isinstance(oj, tuple) else (oj,)):
            b = np.asarray(b)
            np.testing.assert_allclose(_n(a), b, rtol=1e-9,
                                       atol=1e-9 * np.max(np.abs(b)))


def test_rq_standardisation_shifts_log_sf_and_log_sn_only():
    X, y = _problem(n=50, d=3, seed=4)
    y = 40.0 * y + 7.0
    gt = TGP(X, y, kernel="rq", device="cpu")
    hyp = gt.get_default_hyps()
    std = gt._hyp_to_std(hyp)
    shift = np.log(gt._y_sigma)
    np.testing.assert_array_equal(std[:3], hyp[:3])          # log l
    assert std[3] == pytest.approx(hyp[3] - shift, rel=1e-14)  # log sf
    assert std[4] == hyp[4]                                  # log alpha
    assert std[5] == pytest.approx(hyp[5] - shift, rel=1e-14)  # log sn
    np.testing.assert_allclose(gt._hyp_from_std(std), hyp, rtol=1e-14)
    gj = gp_tpu.GP(X, y, kernel="rq")
    np.testing.assert_allclose(std, gj._hyp_to_std(hyp), rtol=1e-14)


@pytest.mark.parametrize("kernel", NAMES)
def test_gp_from_state_takes_every_new_name(kernel):
    X, y = _problem(n=80, d=3, seed=5)
    gj = gp_tpu.GP(X, y, kernel=kernel)
    hyp = _hyp(gj, np.random.default_rng(2))
    gj.set_fixed(True)
    gj.train(init_hyps=hyp)
    gt = gp_from_state({"x": X, "y": y, "hyps": hyp, "kernel": kernel},
                       device="cpu")
    assert gt.num_hyp == gj.num_hyp == tk.get_kernel(kernel).num_hyp(3) + 2
    Xs = _problem(n=10, d=3, seed=6)[0]
    for a, b in zip(gt.batch_predict(Xs), gj.batch_predict(Xs)):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-9)
    with pytest.raises(ValueError, match="hyps"):
        gp_from_state({"x": X, "y": y, "hyps": hyp[:-1], "kernel": kernel},
                      device="cpu")


@pytest.mark.parametrize("kernel", NAMES)
def test_train_runs_for_every_name(kernel):
    X, y = _problem(n=40, d=3, seed=8)
    gt = TGP(X, y, kernel=kernel, device="cpu")
    nll = gt.train()
    assert np.isfinite(nll) and gt.trained
    assert not np.allclose(gt.get_hyp(), gt.get_default_hyps())
    mu, s2 = gt.batch_predict(X[:5])
    assert torch.isfinite(mu).all() and torch.isfinite(s2).all()


@pytest.mark.parametrize("kernel", NAMES)
def test_default_device_raises_without_cuda(monkeypatch, kernel):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _problem(n=20, d=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TGP(X, y, kernel=kernel)
