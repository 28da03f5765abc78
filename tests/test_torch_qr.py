"""gp_tpu_torch's QR solver strategies (ops/qr_pivot.py, ops/solvers.py and
the QR paths of models/exact.py) against gp_tpu's, on the CPU in float64.

The pivoted factorization at 1e-12 of max |K| with the same pivots, the
NLL at rtol 1e-10 and the port's analytic gradient at rtol 1e-7 of
gp_tpu's reverse-mode AD through the factorization, set_k's rescue, a
fit, predictions and checkpoints.

On a rank-deficient K the pivots are equal up to the numerical rank: exact
ties (duplicated rows) are broken by the first position in both packages.
Past the rank the downdated norms are rounding residues (~1e-15), and the
order of the last pivots is rounding's; a K with zero columns, whose
residues are exact zeros, has every pivot equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_tpu
from gp_tpu.models import exact as je
from gp_tpu.models.bucketed import BucketedGP as JB
from gp_tpu.ops import qr_pivot as jq
from gp_tpu.ops.kernels import get_kernel as j_kernel
from gp_tpu.ops.solvers import get_solver as j_solver
from gp_tpu.utils import checkpoint as jck
from gp_tpu_torch import FITC, GP as TGP
from gp_tpu_torch.models import exact as te
from gp_tpu_torch.models.bucketed import BucketedGP as TB
from gp_tpu_torch.ops import qr_pivot as tq
from gp_tpu_torch.ops.kernels import get_kernel as t_kernel
from gp_tpu_torch.ops.solvers import get_solver as t_solver
from gp_tpu_torch.utils import checkpoint as tck

SOLVERS = ["qr", "qr_pivot"]


def _n(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _se(X, noise=0.0):
    d2 = np.sum((X[:, None, :] - X[None, :, :]) ** 2, axis=-1)
    return np.exp(-0.5 * d2) + noise * np.eye(len(X))


def _duplicated(seed=0, n0=40, ndup=20):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n0, 3))
    return np.vstack([X, X[rng.choice(n0, ndup, replace=False)]])


def _matrix(kind):
    """(K, numerical rank)."""
    rng = np.random.default_rng(5)
    if kind == "random":
        A = rng.standard_normal((70, 70))
        return A @ A.T + np.eye(70), 70
    if kind == "zero_columns":
        A = rng.standard_normal((60, 60))
        A = A @ A.T
        z = rng.choice(60, 15, replace=False)
        A[z] = 0.0
        A[:, z] = 0.0
        return A, 45
    return _se(_duplicated()), 40


def _problem(n=60, d=2, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, d))
    y = np.sin(2 * X[:, 0]) + 0.3 * X[:, 1] + 0.1 * rng.standard_normal(n)
    return X, y


@pytest.mark.parametrize("kind", ["random", "zero_columns", "duplicated"])
def test_qr_pivot_matches_gp_tpu(kind):
    K, r = _matrix(kind)
    Qj, Rj, pj = (np.asarray(a) for a in jq.qr_pivot(jnp.asarray(K)))
    Qt, Rt, pt = (_n(a) for a in tq.qr_pivot(torch.tensor(K)))
    assert pt.dtype == np.int64
    tol = 1e-12 * np.abs(K).max()
    np.testing.assert_array_equal(pt[:r], pj[:r])
    assert sorted(pt[r:]) == sorted(pj[r:])
    # R's first r rows, each column under its original index
    np.testing.assert_allclose(Rt[:r, np.argsort(pt)],
                               Rj[:r, np.argsort(pj)], rtol=0, atol=tol)
    np.testing.assert_allclose(Qt[:, :r], Qj[:, :r], rtol=0, atol=tol)
    if kind != "duplicated":
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_allclose(Rt, Rj, rtol=0, atol=tol)
        np.testing.assert_allclose(Qt, Qj, rtol=0, atol=tol)
    # K[:, perm] = Q R and Q orthonormal
    np.testing.assert_allclose(Qt @ Rt, K[:, pt], rtol=0, atol=tol * 10)
    np.testing.assert_allclose(Qt.T @ Qt, np.eye(len(K)), atol=1e-12)
    # past the rank the diagonal is a rounding residue in both
    assert np.all(np.abs(np.diag(Rt)[r:]) < 1e-6)
    assert np.all(np.abs(np.diag(Rj)[r:]) < 1e-6)


@pytest.mark.parametrize("kind", ["random", "zero_columns", "duplicated"])
def test_qrp_ok_logdet_and_solve(kind):
    K, r = _matrix(kind)
    fj = jq.qr_pivot(jnp.asarray(K))
    ft = tq.qr_pivot(torch.tensor(K))
    ok = bool(tq.qrp_ok(ft[1]))
    assert ok == bool(jq.qrp_ok(fj[1])) == (kind == "random")
    if not ok:
        return
    np.testing.assert_allclose(float(tq.qrp_logabsdet(ft[1])),
                               float(jq.qrp_logabsdet(fj[1])), rtol=1e-12)
    np.testing.assert_allclose(float(tq.qrp_logabsdet(ft[1])),
                               np.linalg.slogdet(K)[1], rtol=1e-12)
    b = np.random.default_rng(1).standard_normal((len(K), 3))
    for rhs in (b, b[:, 0]):
        xt = _n(tq.qrp_solve(*ft, torch.tensor(rhs)))
        np.testing.assert_allclose(
            xt, np.asarray(jq.qrp_solve(*fj, jnp.asarray(rhs))),
            rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(K @ xt, rhs, atol=1e-9)


@pytest.mark.parametrize("kernel", ["se_ard", "matern52"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_nll_and_objective_match_gp_tpu(solver, kernel):
    """The NLL at rtol 1e-10; the port's analytic gradient at rtol 1e-7 of
    gp_tpu's AD through the factorization (objective_vg), at a point off
    the defaults."""
    X, y = _problem(n=70, d=3, seed=0)
    jk, tk = j_kernel(kernel), t_kernel(kernel)
    js, ts = j_solver(solver), t_solver(solver)
    rng = np.random.default_rng(2)
    for shift in (0.4,):
        hyp = np.concatenate([np.full(tk.num_hyp(3), 0.1), [-1.5, 0.2]])
        hyp = hyp + shift * rng.standard_normal(hyp.shape)
        np.testing.assert_allclose(
            float(te.nll_raw(tk, torch.tensor(hyp), torch.tensor(X),
                             torch.tensor(y), ts)),
            float(je.nll_raw(jk, jnp.asarray(hyp), jnp.asarray(X),
                             jnp.asarray(y), js)), rtol=1e-10)
        fj, gj = je.objective_vg(jk, False, jnp.asarray(hyp), jnp.asarray(X),
                                 jnp.asarray(y), js)
        ft, gt = te.objective_vg(tk, False, torch.tensor(hyp),
                                 torch.tensor(X), torch.tensor(y), ts)
        np.testing.assert_allclose(float(ft), float(fj), rtol=1e-10)
        np.testing.assert_allclose(_n(gt), np.asarray(gj), rtol=1e-7,
                                   atol=1e-7 * np.abs(np.asarray(gj)).max())
        # and the Cholesky objective's gradient at the same point
        _, gc = te.objective_vg(tk, False, torch.tensor(hyp),
                                torch.tensor(X), torch.tensor(y))
        np.testing.assert_allclose(_n(gt), _n(gc), rtol=1e-7,
                                   atol=1e-7 * np.abs(_n(gc)).max())


@pytest.mark.parametrize("solver", SOLVERS)
def test_set_k_rescue_on_duplicated_rows(solver):
    """Duplicated rows at a tiny noise: the solver refuses K, and the
    sqrt(10) ladder ends on the same noise in both packages."""
    X = _duplicated(seed=1, n0=30, ndup=10)
    y = np.sin(X[:, 0])
    hyp = np.array([0.0, 0.0, 0.0, 0.0, np.log(1e-9), 0.0])
    k, ks = t_kernel("se_ard"), j_kernel("se_ard")
    ht, ft, at, okt = te.set_k(k, torch.tensor(hyp), torch.tensor(X),
                               torch.tensor(y), t_solver(solver))
    hj, fj, aj, okj = je.set_k(ks, jnp.asarray(hyp), jnp.asarray(X),
                               jnp.asarray(y), j_solver(solver))
    assert okt and bool(okj)
    assert not bool(t_solver(solver).ok(t_solver(solver).factor(
        torch.tensor(_se(X, 1e-18)))))
    assert float(ht[-2]) > np.log(1e-9)
    np.testing.assert_allclose(float(ht[-2]), float(hj[-2]), rtol=1e-12)
    # K is near singular at the rescued noise (cond ~ 1e10): alpha is
    # held to its residual, not across the packages
    K = _se(X, np.exp(2 * float(ht[-2])))
    for a in (_n(at), np.asarray(aj)):
        assert np.linalg.norm(K @ a - y) < 1e-5 * np.linalg.norm(y)


def test_train_matches_gp_tpu():
    """A short fit with the reference's default solver: the final f at
    rtol 1e-9 of gp_tpu's from the same data and defaults."""
    X, y = _problem()
    gj = gp_tpu.GP(X, y, solver="qr_pivot")
    gt = TGP(X, y, solver="qr_pivot", device="cpu")
    np.testing.assert_allclose(gt.train(), gj.train(), rtol=1e-9)
    np.testing.assert_allclose(gt.get_hyp(), np.asarray(gj.get_hyp()),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("solver", SOLVERS)
def test_predict_matches_gp_tpu(solver):
    """set_k and the predictions through the solver's factors at the same
    hyps: batch_predict and batch_predict_s2_with_grad."""
    X, y = _problem()
    Xs = np.random.default_rng(4).uniform(-2, 2, (7, 2))
    hyp = np.array([0.5, 0.2, 0.1, -2.2, 0.05])
    gj = gp_tpu.GP(X, y, solver=solver)
    gt = TGP(X, y, solver=solver, device="cpu")
    gj._hyps, gt._hyps = jnp.asarray(hyp), torch.tensor(hyp)
    for g in (gj, gt):
        g._update_posterior()
        g._trained = True
    for a, b in zip(gt.batch_predict(Xs), gj.batch_predict(Xs)):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-9)
    for a, b in zip(gt.batch_predict_s2_with_grad(Xs),
                    gj.batch_predict_s2_with_grad(Xs)):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-8,
                                   atol=1e-10)


@pytest.mark.parametrize("solver", SOLVERS)
def test_checkpoint_carries_a_qr_posterior(solver, tmp_path):
    """(Q, R[, perm], invKys) in gp_tpu's format: the port's file loads in
    the port bit for bit, gp_tpu's in the port, and the port's in gp_tpu
    (whose load_model casts perm to the model's dtype, so its pivoted
    predictions cannot index with it: there the arrays are compared)."""
    X, y = _problem(n=40)
    Xs = np.random.default_rng(6).uniform(-2, 2, (5, 2))
    hyp = np.array([0.1, -0.2, 0.0, -2.0, 0.1])
    gt = TGP(X, y, solver=solver, device="cpu")
    gt._hyps = torch.tensor(hyp)
    gt._update_posterior()
    gt._trained = True
    assert len(gt._post) == (4 if solver == "qr_pivot" else 3)
    path = str(tmp_path / "t.npz")
    gt.save(path)
    r = TGP.load(path, device="cpu")
    assert r.solver.name == solver
    for a, b in zip(r._post, gt._post):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(r.batch_predict(Xs), gt.batch_predict(Xs)):
        assert torch.equal(a, b)
    j = jck.load_model(path)
    for a, b in zip(j._post, gt._post):
        np.testing.assert_array_equal(np.asarray(a), _n(b))
    if solver == "qr":
        for a, b in zip(j.batch_predict(Xs), gt.batch_predict(Xs)):
            np.testing.assert_allclose(np.asarray(a), _n(b), rtol=1e-10)
    gj = gp_tpu.GP(X, y, solver=solver)
    gj._hyps = jnp.asarray(hyp)
    gj._update_posterior()
    gj._trained = True
    jpath = str(tmp_path / "j.npz")
    jck.save_model(gj, jpath)
    t = tck.load_model(jpath, device="cpu")
    for a, b in zip(t.batch_predict(Xs), gj.batch_predict(Xs)):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-10)


def test_bucketed_qr_pivot_absorbs_by_refit():
    """BucketedGP with a QR solver takes gp_tpu's fallback: absorb appends
    the row and refactorizes (bucketed.py:90-100)."""
    X, y = _problem(n=30)
    hyp = np.array([0.1, -0.2, 0.0, -2.0, 0.1])
    bt = TB(X[:-1], y[:-1], bucket=16, solver="qr_pivot", device="cpu")
    bj = JB(X[:-1], y[:-1], bucket=16, solver="qr_pivot")
    bt._hyps = torch.tensor(hyp)
    bj._hyps = jnp.asarray(hyp)
    for b in (bt, bj):
        b._update_posterior()
        b._trained = True
        b.absorb(X[-1], y[-1])
    assert bt.num_train == bj.num_train == 30
    assert bt._post[2].shape == (32,)        # perm, at capacity
    Xs = np.random.default_rng(8).uniform(-2, 2, (4, 2))
    for a, b in zip(bt.batch_predict(Xs), bj.batch_predict(Xs)):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-9)


def test_sparse_models_accept_a_solver_name():
    """FITC / VFE take a solver name and keep their Cholesky path, as
    gp_tpu's do."""
    X, y = _problem(n=30)
    f = FITC(X, y, solver="qr_pivot", device="cpu")
    assert f.solver.name == "qr_pivot"
    hyp = np.array([0.1, -0.2, 0.0, -2.0, 0.1])
    ref = FITC(X, y, device="cpu")
    np.testing.assert_array_equal(f.nll(hyp), ref.nll(hyp))
