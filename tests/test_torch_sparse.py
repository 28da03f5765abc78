"""gp_tpu_torch's FITC and VFE against gp_tpu's, on the CPU in float64.

NLL at rtol 1e-10, gradients at rtol 1e-7 (ROADMAP's bounds); set_k's
jitter exactly where the factors' success is not decided by rounding;
predictions at rtol 1e-9 and input gradients at rtol 1e-7 from the same
hyps; fits from the same start at the final f, rtol 1e-9, where gp_tpu
stops inside its budget.  gp_tpu's K2 runs through its own CPU path, as
tests/test_sparse.py runs it.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_tpu
from gp_tpu.models import fitc as jf
from gp_tpu.models import vfe as jv
from gp_tpu_torch import FITC, VFE
from gp_tpu_torch.models import fitc as tf
from gp_tpu_torch.models import sparse as ts
from gp_tpu_torch.models import vfe as tv
from gp_tpu_torch.utils.convert import gp_from_state

MODELS = {"fitc": (gp_tpu.FITC, FITC, jf, tf),
          "vfe": (gp_tpu.VFE, VFE, jv, tv)}
HYP = np.array([0.3, -0.1, 0.2, -2.3, 0.1])  # d = 2 SE-ARD, noise, mean
HYP.flags.writeable = False


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(42)
    X = rng.uniform(-3, 3, (100, 2))
    y = np.sin(X[:, 0]) * np.cos(X[:, 1]) + 0.05 * rng.standard_normal(100)
    U = X[-20:]                      # the last M rows, as gp_tpu's CLI
    Xs = rng.uniform(-3, 3, (12, 2))
    return X, y, U, Xs


def _pair(name, X, y, U, **kw):
    J, T, _, _ = MODELS[name]
    a, b = J(X, y), T(X, y, device="cpu", **kw)
    a.set_inducing(U)
    b.set_inducing(U)
    return a, b


def _n(t):
    return t.detach().cpu().numpy()


def _close(t, j, rtol):
    j = np.asarray(j)
    np.testing.assert_allclose(_n(t), j, rtol=rtol,
                               atol=rtol * np.max(np.abs(j)))


@pytest.mark.parametrize("name", ["fitc", "vfe"])
def test_nll_and_gradient_match(name, problem):
    X, y, U, _ = problem
    a, b = _pair(name, X, y, U)
    _, _, jm, tm = MODELS[name]
    assert b.dtype == torch.float64 and b.device.type == "cpu"
    np.testing.assert_allclose(b.nll(HYP), a.nll(HYP), rtol=1e-10)
    rng = np.random.default_rng(1)
    for shift in (0.0, 0.4):
        vec = a._hyp_to_std(HYP + shift * rng.uniform(-1, 1, HYP.shape))
        fj, gj = jm.objective_vg(a.kernel, False, jnp.asarray(vec), a._x,
                                 a._ys, a._u, jnp.asarray(a._jitter_std))
        ft, gt = tm.objective_vg(b.kernel, False, torch.tensor(vec), b._x,
                                 b._ys, b._u, b._tensor(b._jitter_std))
        np.testing.assert_allclose(float(ft), float(fj), rtol=1e-10)
        _close(gt, gj, 1e-7)


@pytest.mark.parametrize("name", ["fitc", "vfe"])
def test_search_objective_matches(name, problem):
    """The global search's objective, with the sn2 > mean(sf2) rejection."""
    X, y, U, _ = problem
    a, b = _pair(name, X, y, U)
    for shift in (0.0, 4.0):
        h = HYP.copy()
        h[-2] += shift
        vec = a._hyp_to_std(h)
        vj = float(a._multistart_objective()(jnp.asarray(vec)))
        vt = b._multistart_objective()(torch.tensor(vec)[None])
        assert vt.shape == (1,)
        assert (float(vt[0]) == np.inf) == (vj == np.inf) == (shift > 0)
        if shift == 0:
            np.testing.assert_allclose(float(vt[0]), vj, rtol=1e-10)


@pytest.mark.parametrize("name", ["fitc", "vfe"])
def test_set_k_and_predictions_match(name, problem):
    X, y, U, Xs = problem
    a, b = _pair(name, X, y, U)
    for m in (a, b):
        m._hyps = m._tensor(HYP) if m is b else jnp.asarray(HYP)
        m._update_posterior()
        m._trained = True
    assert b._jitter_u == a._jitter_u == (0.1 * 1e-3) ** 2
    for j, t in zip(a._post, b._post):
        _close(t, j, 1e-9)
    for fn in ("batch_predict", "batch_predict_y", "batch_predict_s2"):
        outj, outt = getattr(a, fn)(Xs), getattr(b, fn)(Xs)
        for j, t in zip(outj if isinstance(outj, tuple) else (outj,),
                        outt if isinstance(outt, tuple) else (outt,)):
            assert isinstance(t, torch.Tensor)
            _close(t, j, 1e-9)
    for fn in ("batch_predict_y_with_grad", "batch_predict_s2_with_grad"):
        (vj, gj), (vt, gt) = getattr(a, fn)(Xs), getattr(b, fn)(Xs)
        _close(vt, vj, 1e-9)
        assert gt.shape == Xs.shape
        _close(gt, gj, 1e-7)
    # a float32 query is cast to the model's float64
    mu32 = b.batch_predict_y(torch.tensor(Xs, dtype=torch.float32))
    assert mu32.dtype == torch.float64
    yj, _, gyj, _ = a.predict_with_grad(Xs[0])
    yt, _, gyt, _ = b.predict_with_grad(Xs[0])
    np.testing.assert_allclose(yt, yj, rtol=1e-9)
    _close(gyt, gyj, 1e-7)


@pytest.mark.parametrize("name", ["fitc", "vfe"])
def test_set_k_jitter_doubling(name, problem):
    """Inducing points given twice make Kuu singular: both doubling loops
    start from a jitter too small to help and end with SPD factors.  The
    step at which a singular Kuu plus jitter factors is decided by the
    rounding of the two LAPACK builds, so the jitters are held to one
    doubling of each other.  A NaN Kuu never factors: exactly 64
    doublings on both sides, and the model refuses the posterior."""
    X, y, _, _ = problem
    _, T, jm, tm = MODELS[name]
    kernel = T(X, y, device="cpu").kernel
    U2 = np.concatenate([X[:10], X[:10]])
    args = (np.asarray(HYP), X, y, U2)
    rj = jm.set_k(gp_tpu.ops.kernels.get_kernel("se_ard"),
                  *map(jnp.asarray, args), jnp.asarray(1e-20))
    rt = tm.set_k(kernel, *map(torch.tensor, args),
                  torch.tensor(1e-20, dtype=torch.float64))
    assert bool(rj[4]) and rt[4]
    assert float(rj[3]) > 1e-20 and float(rt[3]) > 1e-20
    assert 0.5 <= float(rt[3]) / float(rj[3]) <= 2.0
    bad = HYP.copy()
    bad[:2] = -800.0                 # 1/l overflows: K(U, U) is NaN
    args = (bad, X, y, U2)
    rj = jm.set_k(gp_tpu.ops.kernels.get_kernel("se_ard"),
                  *map(jnp.asarray, args), jnp.asarray(1e-8))
    rt = tm.set_k(kernel, *map(torch.tensor, args),
                  torch.tensor(1e-8, dtype=torch.float64))
    assert not bool(rj[4]) and not rt[4]
    # FITC's last jitter 1e-8 2^64; VFE's sum of the 64 added, the same
    # value in float64
    assert float(rt[3]) == float(rj[3]) == 1e-8 * 2.0 ** 64
    m = T(X, y, device="cpu")
    m._hyps = m._tensor(bad)
    with pytest.raises(RuntimeError, match="jitter doubling"):
        m._update_posterior()


@pytest.mark.parametrize("name", ["fitc", "vfe"])
def test_fit_matches_gp_tpu(name, problem):
    """train() from the defaults: both stop inside the budget, at one f."""
    X, y, U, _ = problem
    a, b = _pair(name, X, y, U)
    nj, nt = a.train(), b.train()
    ej, et = int(a.last_opt_result.evals), int(b.last_opt_result.evals)
    assert ej < a._MAX_EVAL and et < b._MAX_EVAL == a._MAX_EVAL
    np.testing.assert_allclose(float(b.last_opt_result.f),
                               float(a.last_opt_result.f), rtol=1e-9)
    np.testing.assert_allclose(nt, nj, rtol=1e-9)
    assert b._jitter_u == a._jitter_u
    assert bool(b.last_opt_result.converged) == bool(
        a.last_opt_result.converged)


@pytest.mark.parametrize("name", ["fitc", "vfe"])
def test_test_obj_matches(name, problem):
    X, y, U, _ = problem
    a, b = _pair(name, X, y, U)
    vj, gj, fdj = a.test_obj(HYP)
    vt, gt, fdt = b.test_obj(HYP)
    np.testing.assert_allclose(vt, vj, rtol=1e-10)
    _close(torch.tensor(gt), gj, 1e-7)
    # the finite differences of the two agree as far as eps lets them
    eps = 1e-3 if name == "fitc" else 1e-6
    np.testing.assert_allclose(fdt, fdj, atol=1e-9 / eps * abs(vj))


@pytest.mark.parametrize("name", ["fitc", "vfe"])
def test_noise_free_refused(name, problem):
    X, y, U, _ = problem
    a, b = _pair(name, X, y[:len(X)], U)
    for m in (a, b):
        m.set_noise_free(True)
        m._fixhyps = True            # the refusal, not the fit
        with pytest.warns(UserWarning, match="can't be noise free"):
            nll = m.train(HYP)
        assert not m.noise_free and np.isfinite(nll)
    np.testing.assert_allclose(b.nll(), a.nll(), rtol=1e-10)


def test_envelope_trips_under_budget(monkeypatch, problem):
    X, y, U, _ = problem
    # 8 panels of 100 x 20 float64: 128000 bytes
    monkeypatch.setenv("GP_TPU_HBM_BYTES", "100000")
    with pytest.raises(ValueError) as tj:
        gp_tpu.models.sparse.check_nm_envelope(100, 20, 8)
    with pytest.raises(ValueError) as tt:
        ts.check_nm_envelope(100, 20, 8)
    assert str(tt.value) == str(tj.value)
    a, b = _pair("fitc", X, y, U)
    with pytest.raises(ValueError, match="HBM budget"):
        b.train()
    monkeypatch.setenv("GP_TPU_HBM_BYTES", "128000")
    ts.check_nm_envelope(100, 20, 8)
    monkeypatch.delenv("GP_TPU_HBM_BYTES")
    assert ts.hbm_budget_bytes() == gp_tpu.models.sparse.hbm_budget_bytes()


def test_defaults_and_device(problem):
    X, y, U, _ = problem
    b = VFE(X.astype(np.float32), y, device="cpu")
    assert b.dtype == torch.float64 and b.num_inducing == len(X)
    b.set_inducing(torch.tensor(U, dtype=torch.float32))
    assert b.inducing.dtype == torch.float64 and b.num_inducing == len(U)
    with pytest.raises(NotImplementedError, match="module 14"):
        b.train_distributed(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FITC(X, y)


@pytest.mark.parametrize("name", ["fitc", "vfe"])
def test_state_carries_a_trained_model(name, problem):
    """gp_from_state takes a trained gp_tpu FITC / VFE under its
    checkpoint's names (model, inducing, jitter_u and the GP fields)."""
    X, y, U, Xs = problem
    J = MODELS[name][0]
    a = J(X, y)
    a.set_inducing(U)
    a.set_noise_lower_bound(1e-2)
    a.train()
    state = {"model": type(a).__name__, "x": np.asarray(a._x),
             "y": np.asarray(a._y), "hyps": np.asarray(a._hyps),
             "kernel": a.kernel.name, "dtype": "float64",
             "noise_lb": a._noise_lb, "inducing": np.asarray(a._u),
             "jitter_u": a._jitter_u}
    b = gp_from_state(state, device="cpu")
    assert type(b).__name__ == type(a).__name__ and b.trained
    assert b._jitter_u == a._jitter_u and b._noise_lb == 1e-2
    for j, t in zip(a.batch_predict(Xs), b.batch_predict(Xs)):
        _close(t, j, 1e-9)
    np.testing.assert_allclose(b.nll(), a.nll(), rtol=1e-10)


def test_fitc_select_init_hyp_matches(problem):
    """The global search over the FITC objective, gp_tpu's draws replayed
    (tests/test_torch_multistart.py)."""
    import jax
    from test_torch_multistart import Replay, mvmo_draws
    X, y, U, _ = problem
    a, b = _pair("fitc", X, y, U)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    num, chunk = 40, a._multistart_chunk()
    b.draws = Replay(mvmo_draws(sub, num, chunk, b.num_hyp))
    hj = a.select_init_hyp(num, a.get_default_hyps())
    ht = b.select_init_hyp(num, b.get_default_hyps())
    assert not b.draws.queue
    np.testing.assert_allclose(ht, hj, rtol=1e-9)
