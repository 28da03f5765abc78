"""gp_tpu_torch's exact GP against gp_tpu's, on the CPU in float64.

NLL at rtol 1e-10 and gradient at rtol 1e-7 (the bounds tests/test_golden.py
holds gp_tpu to).  End-to-end fits: final NLL at rtol 1e-6, hyps at atol
1e-4, predictions at rtol 1e-5, on problems where both optimizers stop
inside the budget.  The two optimizers run
the same algorithm on objectives that differ in the last bits (LAPACK
inverse vs gp_tpu's triangular inverse), and on harder problems their
trajectories part: on a 5-d ARD problem (seed 0 of `_problem`) the
evaluation points agree to 1e-14 for ~20 evaluations, then drift apart by
~3x per evaluation from evaluation ~26 on, and a fit stopped by the
160-evaluation budget ends ~2e-6 relative apart in NLL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_tpu
from gp_tpu.models import exact as je
from gp_tpu.optim.lbfgsb import explain_result as j_explain
from gp_tpu.optim.lbfgsb import lbfgsb_impl as j_lbfgsb
from gp_tpu_torch import GP as TGP
from gp_tpu_torch.models import exact as te
from gp_tpu_torch.optim.lbfgsb import explain_result, lbfgsb_impl
from gp_tpu_torch.utils.convert import gp_from_state


def _problem(n=300, d=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, d))
    y = (np.sin(2 * X[:, 0]) + 0.5 * np.cos(3 * X[:, 1])
         + 0.3 * X[:, 2] * X[:, -1] + 0.1 * rng.standard_normal(n))
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
    return h + rng.uniform(-shift, shift, h.shape)


@pytest.mark.parametrize("kernel", ["se_ard", "se_iso"])
@pytest.mark.parametrize("noise_free", [False, True])
def test_nll_and_gradient_match(kernel, noise_free):
    n = 40 if noise_free else 300
    X, y = _problem(n=n, d=5, seed=3)
    gj, gt = _pair(kernel, X, y)
    rng = np.random.default_rng(0)
    hyp = _hyp(gj, rng)
    if noise_free:
        hyp[-2] = -np.inf
        hyp[:-2] -= 0.7          # shorter scales: well-conditioned K
    vj = je.nll(gj.kernel, jnp.asarray(hyp), gj._x, gj._y)
    vt = te.nll(gt.kernel, _t(hyp), gt._x, gt._y)
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-10)
    fj, g_j = je.nll_vg_raw(gj.kernel, jnp.asarray(hyp), gj._x, gj._y)
    ft, g_t = te.nll_vg_raw(gt.kernel, _t(hyp), gt._x, gt._y)
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-10)
    np.testing.assert_allclose(float(ft), float(vt), rtol=1e-10)
    g_j = np.asarray(g_j)
    g_t = _n(g_t)
    if noise_free:               # g_noise = sn2 tr(Q) = 0 at sn2 = 0
        assert g_t[-2] == 0.0 and g_j[-2] == 0.0
    np.testing.assert_allclose(g_t, g_j, rtol=1e-7,
                               atol=1e-7 * np.max(np.abs(g_j)))
    # noise-free optimization vector drops log sn
    vec = np.delete(gj._hyp_to_std(hyp), -2) if noise_free \
        else gj._hyp_to_std(hyp)
    oj = je.objective_vg(gj.kernel, noise_free, jnp.asarray(vec), gj._x,
                         gj._ys)
    ot = te.objective_vg(gt.kernel, noise_free, _t(vec), gt._x, gt._ys)
    np.testing.assert_allclose(float(ot[0]), float(oj[0]), rtol=1e-10)
    np.testing.assert_allclose(_n(ot[1]), np.asarray(oj[1]), rtol=1e-7,
                               atol=1e-7 * np.max(np.abs(oj[1])))


@pytest.mark.parametrize("kernel", ["se_ard", "se_iso"])
def test_multistart_objective_matches(kernel):
    X, y = _problem(n=150, d=4, seed=6)
    gj, gt = _pair(kernel, X, y)
    rng = np.random.default_rng(1)
    for shift in (0.0, 3.0):          # 3.0: sn2 > mean(sf2) is rejected
        hyp = _hyp(gj, rng)
        hyp[-2] += shift
        vec = gj._hyp_to_std(hyp)
        vj = float(je.multistart_objective(gj.kernel, False,
                                           jnp.asarray(vec), gj._x, gj._ys))
        vt = float(te.multistart_objective(gt.kernel, False, _t(vec),
                                           gt._x, gt._ys))
        assert (vt == np.inf) == (vj == np.inf)
        if vj != np.inf:
            np.testing.assert_allclose(vt, vj, rtol=1e-10)


def test_check_gradients_and_add_data():
    X, y = _problem(n=120, d=3, seed=7)
    gt = TGP(X[:100], y[:100], device="cpu")
    g, fd, rel = gt.check_gradients()
    assert g.shape == fd.shape == (6,) and rel < 1e-5
    gt.add_data(X[100:], y[100:])
    assert gt.num_train == 120 and not gt.trained
    full = TGP(X, y, device="cpu")
    np.testing.assert_array_equal(gt.get_default_hyps(),
                                  full.get_default_hyps())
    assert gt.nll() == full.nll()


@pytest.mark.parametrize("kernel", ["se_ard", "se_iso"])
def test_non_spd_point_gives_inf(kernel):
    X, y = _problem(n=120, d=3, seed=4)
    gj, gt = _pair(kernel, X, y)
    hyp = np.asarray(gj.get_default_hyps(), np.float64)
    hyp[:-2] += 6.0              # huge length scales: K ~ sf2 ones ...
    hyp[-2] = -40.0              # ... and no noise: numerically non-SPD
    assert float(je.nll(gj.kernel, jnp.asarray(hyp), gj._x, gj._y)) \
        == np.inf
    assert float(te.nll(gt.kernel, _t(hyp), gt._x, gt._y)) == np.inf
    assert gt.nll(hyp) == gj.nll(hyp) == np.inf
    f, g = te.objective_vg(gt.kernel, False, _t(gt._hyp_to_std(hyp)),
                           gt._x, gt._ys)
    assert float(f) == np.inf and np.all(_n(g) == 0.0)


@pytest.mark.parametrize("budget", [1, 2, 5, 10, 15])
def test_lbfgsb_first_evaluations_match(budget):
    """gp_tpu's lbfgsb_impl and the port on the same f64 ARD objective."""
    X, y = _problem(n=300, d=5, seed=0)
    gj, gt = _pair("se_ard", X, y)
    h = gj._hyp_to_std(gj.get_default_hyps())
    lb, ub = gj._std_bounds()
    x0 = np.clip(h, lb, ub)
    fj = lambda v: je.objective_vg(gj.kernel, False, v, gj._x, gj._ys)
    rj = jax.jit(lambda v: j_lbfgsb(fj, v, jnp.asarray(lb), jnp.asarray(ub),
                                    max_evals=budget))(jnp.asarray(x0))
    ft = lambda v: te.objective_vg(gt.kernel, False, v, gt._x, gt._ys)
    rt = lbfgsb_impl(ft, _t(x0), _t(lb), _t(ub), max_evals=budget)
    assert rt.evals == int(rj.evals)
    assert rt.converged == bool(rj.converged)
    assert explain_result(rt).split(":")[0] == j_explain(rj).split(":")[0]
    np.testing.assert_allclose(_n(rt.x), np.asarray(rj.x), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(float(rt.f), float(rj.f), rtol=1e-9)
    np.testing.assert_allclose(_n(rt.g), np.asarray(rj.g), rtol=1e-7,
                               atol=1e-7 * np.max(np.abs(rj.g)))


# the fits' problems (also read by scripts/lbfgsb_stops.py)
FITS = {"se_ard": dict(n=300, d=5, seed=1), "se_iso": dict(n=300, d=5,
                                                           seed=0)}


@pytest.fixture(scope="module", params=["se_ard", "se_iso"])
def trained(request):
    kernel = request.param
    X, y = _problem(**FITS[kernel])
    gj, gt = _pair(kernel, X, y)
    return gj, gt, gj.train(), gt.train(), _problem(n=40, d=5, seed=9)[0]


def test_train_matches_gp_tpu(trained):
    gj, gt, vj, vt, _ = trained
    rj, rt = gj.last_opt_result, gt.last_opt_result
    # converged is isfinite(f) in both; the port stops inside the budget
    assert rt.converged == bool(rj.converged)
    status = explain_result(rt)
    assert status.startswith("SUCCESS")
    # how many evaluations a fit spends on f's rounding floor, and so
    # whether it stops inside the budget, is decided by the last bits of
    # f: on se_iso gp_tpu's GP.train reaches the budget (175 evaluations),
    # jax.jit of its lbfgsb_impl on the same objective from the same start
    # stops at 55 and the port at 109, all at one f to 1e-15
    # (scripts/lbfgsb_stops.py).  The statuses are compared where gp_tpu
    # stops inside the budget; on every problem the port ends at its f
    if int(rj.evals) < gj._MAX_EVAL:
        assert status.split(":")[0] == j_explain(rj).split(":")[0]
    np.testing.assert_allclose(float(rt.f), float(rj.f), rtol=1e-9)
    np.testing.assert_allclose(vt, vj, rtol=1e-6)
    np.testing.assert_allclose(gt.get_hyp(), np.asarray(gj.get_hyp()),
                               atol=1e-4)
    assert not np.allclose(gt.get_hyp(), gt.get_default_hyps())


def test_predictions_match_gp_tpu(trained):
    gj, gt, _, _, Xs = trained
    mj, sj = gj.batch_predict(Xs)
    mt, st = gt.batch_predict(Xs)
    np.testing.assert_allclose(_n(mt), mj, rtol=1e-5)
    np.testing.assert_allclose(_n(st), sj, rtol=1e-5)
    np.testing.assert_allclose(_n(gt.batch_predict_y(Xs)), mj, rtol=1e-5)
    np.testing.assert_allclose(_n(gt.batch_predict_s2(Xs)), sj, rtol=1e-5)
    for fj, ft in ((gj.batch_predict_y_with_grad,
                    gt.batch_predict_y_with_grad),
                   (gj.batch_predict_s2_with_grad,
                    gt.batch_predict_s2_with_grad)):
        vj, dj = fj(Xs)
        vt, dt = ft(Xs)
        np.testing.assert_allclose(_n(vt), vj, rtol=1e-5)
        np.testing.assert_allclose(_n(dt), dj, rtol=1e-5,
                                   atol=1e-5 * np.max(np.abs(dj)))
    y1, g1 = gt.predict_y_with_grad(Xs[3])
    np.testing.assert_allclose(y1, mj[3], rtol=1e-5)


def test_gp_from_state_matches_gp_tpu(trained):
    gj, _, _, _, Xs = trained
    state = {"x": np.asarray(gj._x), "y": np.asarray(gj._y),
             "hyps": np.asarray(gj.get_hyp()), "kernel": gj.kernel.name,
             "dtype": "float64", "noise_free": gj._noise_free,
             "noise_lb": gj._noise_lb}
    gt = gp_from_state(state, device="cpu")
    mj, sj = gj.batch_predict(Xs)
    mt, st = gt.batch_predict(Xs)
    np.testing.assert_allclose(_n(mt), mj, rtol=1e-10)
    np.testing.assert_allclose(_n(st), sj, rtol=1e-10)
    np.testing.assert_allclose(gt.get_hyp(), np.asarray(gj.get_hyp()),
                               rtol=1e-14)


def test_set_k_inflates_noise_like_gp_tpu():
    X, y = _problem(n=60, d=3, seed=5)
    X = np.vstack([X, X[:10]])                 # duplicates: K0 singular
    y = np.concatenate([y, y[:10]])
    gj, gt = _pair("se_ard", X, y)
    hyp = np.asarray(gj.get_default_hyps(), np.float64)
    hyp[-2] = -np.inf
    hj, _, aj, okj = je.set_k(gj.kernel, jnp.asarray(hyp), gj._x, gj._y)
    ht, _, at, okt = te.set_k(gt.kernel, _t(hyp), gt._x, gt._y)
    assert okt and bool(okj)
    # same rung of the ladder; alpha itself is ill-conditioned there
    assert np.isfinite(float(ht[-2])) and float(ht[-2]) == float(hj[-2])
    assert np.all(np.isfinite(_n(at)))


@pytest.mark.parametrize("rel_err", [None, 0.5])
def test_debug_train_start_gradient_check(monkeypatch, capsys, rel_err):
    """GP_TPU_DEBUG=1: train() first runs check_gradients and prints its
    rel_err to stderr, and both gradients when rel_err > 1e-2 (gp_tpu's
    messages, gp_tpu/models/base.py:405-418); without it, nothing."""
    X, y = _problem(n=40, d=3, seed=4)
    monkeypatch.delenv("GP_TPU_DEBUG", raising=False)
    TGP(X, y, device="cpu").train()
    assert "GP_TPU_DEBUG" not in capsys.readouterr().err
    monkeypatch.setenv("GP_TPU_DEBUG", "1")
    gt = TGP(X, y, device="cpu")
    if rel_err is not None:       # a gradient that disagrees
        check = gt.check_gradients
        monkeypatch.setattr(gt, "check_gradients", lambda h: (
            *check(h)[:2], rel_err))
    gt.train()
    err = capsys.readouterr().err
    if rel_err is None:
        rel = float(err.split("rel_err=")[1].split()[0])
        assert rel < 1e-5 and "analytic=" not in err
    else:
        assert "rel_err=5.000e-01" in err
        assert "[GP_TPU_DEBUG]   analytic=[" in err
        assert "[GP_TPU_DEBUG]   numeric =[" in err


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _problem(n=20, d=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TGP(X, y)


def test_unported_paths_raise_not_implemented():
    # the stream regime (module 11) is ported (tests/test_torch_stream.py),
    # and BucketedGP runs its masked programs there, as gp_tpu's
    # (tests/test_torch_bucketed_stream.py)
    assert TGP(np.zeros((32768, 1)), np.zeros(32768),
               device="cpu")._in_stream_regime()
    from gp_tpu_torch import BucketedGP
    bo = BucketedGP(np.zeros((32768, 1)), np.zeros(32768), device="cpu")
    assert bo._in_stream_regime() and not bo._factor_free()
    # the QR strategies (module 12) and the distributed layer (module 14:
    # the 1-D mesh and the 2-D grid) are ported (tests/test_torch_{qr,
    # parallel,pchol2d}.py); the sparse models' distributed fit takes a
    # 1-D mesh only, as gp_tpu's
    assert TGP(np.zeros((4, 1)), np.zeros(4), solver="qr",
               device="cpu").solver.name == "qr"

    class Grid:
        axis_names = ("rowg", "colg")
        shape = {"rowg": 1, "colg": 1}

    assert TGP._is_grid_mesh(Grid())
    from gp_tpu_torch import FITC
    ft = FITC(*_problem(n=20, d=3), device="cpu")
    with pytest.raises(ValueError, match="1-D 'rows' mesh"):
        ft.train_distributed(Grid())
