"""gp_tpu_torch's BucketedGP in the stream regime (N >= _STREAM_MIN_N)
against gp_tpu's, on the CPU in float64, and the masked objective's alpha.

The threshold is lowered in both packages for the whole module (to
STREAM_N = 64 rows), as tests/test_torch_stream.py does, so that a
BucketedGP of N = 80 rows (d = 3, bucket 32, capacity 96) is in the
stream regime and its 40-row warm-start subset is not.  There gp_tpu's
BucketedGP runs its dense masked programs at every stage: train() probes
the subset-MLE warm start, fits the masked objective and returns the
masked NLL; the posterior is set_k_masked's capacity factor; absorb
appends to it.  gp_tpu's variance and input-gradient predictions raise
there (GP._factors' stream-regime assertion), so they are compared with
gp_tpu's threshold restored for that call only: only its guard reads
the constant.

Tolerances: the masked NLL at rtol 1e-10 and its gradient at rtol 1e-7
(ROADMAP's bounds); train() at tests/test_torch_bucketed.py's (NLL rtol
1e-7) and the fitted hyps at atol 1e-4 (tests/test_torch_stream.py's);
posteriors at rtol 1e-10; checkpoints bit for bit.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_tpu import SE_ARD
from gp_tpu.models import exact as je
from gp_tpu.models.bucketed import BucketedGP as JB
from gp_tpu.ops.solvers import QR as J_QR
from gp_tpu.utils import checkpoint as jck
from gp_tpu_torch import BucketedGP
from gp_tpu_torch.models import exact as te
from gp_tpu_torch.ops.kernels import get_kernel
from gp_tpu_torch.ops.solvers import QR as T_QR
from gp_tpu_torch.utils import checkpoint as tck
from gp_tpu_torch.utils.convert import model_from_state

STREAM_N, N, D, BUCKET, CAP = 64, 80, 3, 32, 96
SE = get_kernel("se_ard")


@pytest.fixture(scope="module", autouse=True)
def stream_threshold():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(je, "_STREAM_MIN_N", STREAM_N)
        mp.setattr(te, "_STREAM_MIN_N", STREAM_N)
        yield


@contextlib.contextmanager
def gp_tpu_below_stream():
    """gp_tpu's threshold at its own value, for the calls its stream-
    regime assertion would refuse."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(je, "_STREAM_MIN_N", 32768)
        yield


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(5)
    X = rng.uniform(-2, 2, (N + 28, D))
    y = np.sin(X[:, 0]) + 0.3 * X[:, 1] + 0.05 * rng.standard_normal(N + 28)
    return X[:N], y[:N], X[N:N + 8], X[N + 8:], y[N + 8:]


def _n(t):
    return t.detach().cpu().numpy()


def _train(make):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        m = make()
        return m, m.train(), err.getvalue()


@pytest.fixture(scope="module")
def trained(prob):
    """Each package's BucketedGP(X, y).train() from the defaults, with what
    train() printed on stderr (shared; never mutated)."""
    X, y = prob[0], prob[1]
    return (_train(lambda: JB(X, y, bucket=BUCKET)),
            _train(lambda: BucketedGP(X, y, bucket=BUCKET, device="cpu")))


def _pair(prob, hyp):
    """Both packages' models on prob's rows at hyp, each with its own
    posterior (set_k_masked)."""
    X, y = prob[0], prob[1]
    j = JB(X, y, bucket=BUCKET)
    t = BucketedGP(X, y, bucket=BUCKET, device="cpu")
    j._hyps = jnp.asarray(hyp)
    t._hyps = t._tensor(hyp)
    for m in (j, t):
        m._update_posterior()
        m._trained = True
    return j, t


def _same_posterior(j, t, Xs, rtol=1e-10):
    assert t.num_train == j.num_train and t.capacity == j.capacity
    assert t._in_stream_regime() and j._in_stream_regime()
    assert t._post_aux is None and j._post_aux is None
    for a, b in zip(t._post, j._post, strict=True):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(_n(a), b, rtol=rtol,
                                   atol=rtol * np.abs(b).max())
    np.testing.assert_allclose(t.get_hyp(), j.get_hyp(), rtol=1e-12)
    np.testing.assert_allclose(_n(t.batch_predict_y(Xs)),
                               j.batch_predict_y(Xs), rtol=rtol, atol=rtol)


# -- alpha in the masked objective --------------------------------------------

@pytest.mark.parametrize("seed,log_l", [(0, 1.1), (2, 0.9), (3, 0.9)])
def test_masked_objective_alpha_by_factor_matches_gp_tpu(seed, log_l,
                                                         monkeypatch):
    """gp_tpu's nll_vg_raw_masked takes alpha = chol_solve(L, r) at every N
    (exact.py:1479), here below the stream regime (both thresholds at
    their own value), where GP's dense objective takes K^-1 r.  At a badly
    conditioned K (the noise at its lower bound 1e-3, cond(K) >= 1e8) and
    targets 20 below the mean hyperparameter (r lies mostly along K's
    leading eigenvectors, where K^-1 r by the explicit inverse loses
    most), alpha = K^-1 r moves the NLL past rtol 1e-10; the factor's
    alpha does not."""
    monkeypatch.setattr(je, "_STREAM_MIN_N", 32768)
    monkeypatch.setattr(te, "_STREAM_MIN_N", 32768)
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (N, D))
    y = np.sin(X[:, 0]) + 0.3 * X[:, 1]
    xp, yp = np.zeros((CAP, D)), np.zeros(CAP)
    xp[:N], yp[:N] = X, y
    hyp = np.array([log_l] * D + [0.5, np.log(1e-3), 20.0])
    th, xt, yt = torch.tensor(hyp), torch.from_numpy(xp), torch.from_numpy(yp)
    K = te._masked_k(SE, th[:D + 1], xt, N)[:N, :N] + 1e-6 * torch.eye(N)
    assert float(torch.linalg.cond(K)) >= 1e8
    fj, gj = je.nll_vg_raw_masked(SE_ARD, jnp.asarray(hyp), jnp.asarray(xp),
                                  jnp.asarray(yp), N)
    fj, gj = float(fj), np.asarray(gj)
    ft, gt = te.nll_vg_raw_masked(SE, th, xt, yt, N)
    np.testing.assert_allclose(float(ft), fj, rtol=1e-10)
    np.testing.assert_allclose(_n(gt), gj, rtol=1e-7,
                               atol=1e-7 * np.abs(gj).max())
    # the premise: here the explicit inverse's alpha parts from it
    f_inv = float(te._nll_vg_terms(SE, th, xt[:N], yt[:N], None, False)[0])
    assert abs(f_inv - fj) > 1e-10 * abs(fj)
    vec = jnp.asarray(hyp)
    oj, ogj = je.objective_vg_masked(SE_ARD, False, vec, jnp.asarray(xp),
                                     jnp.asarray(yp), N)
    ot, ogt = te.objective_vg_masked(SE, False, th, xt, yt, N)
    np.testing.assert_allclose(float(ot), float(oj), rtol=1e-10)
    np.testing.assert_allclose(_n(ogt), np.asarray(ogj), rtol=1e-7,
                               atol=1e-7 * np.abs(np.asarray(ogj)).max())


# -- BucketedGP from _STREAM_MIN_N rows ---------------------------------------

def test_train_from_defaults_matches_gp_tpu(prob, trained):
    """Both probe the subset-MLE warm start, fit the masked objective and
    return the masked NLL (no refined NLL, no factor-free posterior)."""
    (j, n_j, err_j), (t, n_t, err_t) = trained
    assert t.capacity == j.capacity == CAP
    for err in (err_j, err_t):
        assert "subset-MLE warm start (m=40)" in err
    np.testing.assert_allclose(n_t, n_j, rtol=1e-7)
    np.testing.assert_allclose(t.get_hyp(), j.get_hyp(), atol=1e-4)
    assert n_t == t.nll(t.get_hyp())
    assert t._post_aux is None and not t._factor_free()
    L, invKys = t._post
    assert L.shape == (CAP, CAP) and invKys.shape == (CAP,)
    np.testing.assert_array_equal(_n(L[N:, N:]), np.eye(CAP - N))


def test_posterior_and_predictions_match_gp_tpu(prob, trained):
    """set_k_masked at gp_tpu's fitted hyps; batch_predict_y as gp_tpu's;
    the variance and gradient predictions as gp_tpu's predict_masked and
    _predict_single_masked (its threshold restored for the call)."""
    Xs = prob[2]
    j, t = _pair(prob, trained[0][0].get_hyp())
    _same_posterior(j, t, Xs)
    with pytest.raises(AssertionError, match="cache no factor"):
        j.batch_predict(Xs)
    with gp_tpu_below_stream():
        mu_j, s2_j = j.batch_predict(Xs)
        s2o_j = j.batch_predict_s2(Xs)
        y_j, gy_j = j.batch_predict_y_with_grad(Xs[:3])
        s_j, gs_j = j.batch_predict_s2_with_grad(Xs[:3])
    mu_t, s2_t = t.batch_predict(Xs)
    np.testing.assert_allclose(_n(mu_t), mu_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(_n(s2_t), s2_j, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(_n(t.batch_predict_s2(Xs)), s2o_j,
                               rtol=1e-9, atol=1e-12)
    y_t, gy_t = t.batch_predict_y_with_grad(Xs[:3])
    np.testing.assert_allclose(_n(y_t), y_j, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(_n(gy_t), gy_j, rtol=1e-8, atol=1e-10)
    s_t, gs_t = t.batch_predict_s2_with_grad(Xs[:3])
    np.testing.assert_allclose(_n(s_t), s_j, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(_n(gs_t), gs_j, rtol=1e-7, atol=1e-10)


def test_absorb_append_then_past_capacity(prob, trained):
    """Appends in O(N^2) up to capacity (80 -> 96, the factor written in
    place), then one past it: add_data (the buffers grow to 128, the
    standardization refreshes) and set_k_masked at the same hyps."""
    Xs, Xn, yn = prob[2], prob[3], prob[4]
    j, t = _pair(prob, trained[0][0].get_hyp())
    L0 = t._post[0]
    for i in range(CAP - N):
        j.absorb(Xn[i], yn[i])
        t.absorb(Xn[i], yn[i])
        assert t._post[0] is L0
    _same_posterior(j, t, Xs)
    mu0 = t._y_mu
    j.absorb(Xn[CAP - N], yn[CAP - N])
    t.absorb(Xn[CAP - N], yn[CAP - N])
    assert t.capacity == j.capacity == CAP + BUCKET and t.trained
    assert t._y_mu != mu0 and t._y_mu == pytest.approx(j._y_mu, rel=1e-15)
    _same_posterior(j, t, Xs)


def test_add_data_then_train_matches_gp_tpu(prob, trained):
    """add_data within capacity (the standardization frozen), then
    train() from the current hyps in both packages."""
    Xn, yn = prob[3], prob[4]
    j, t = _pair(prob, trained[0][0].get_hyp())
    frozen = (t._y_mu, t._y_sigma)
    for m in (j, t):
        m.add_data(Xn[:6], yn[:6])
    assert t.capacity == j.capacity == CAP and t.num_train == N + 6
    assert (t._y_mu, t._y_sigma) == frozen == (j._y_mu, j._y_sigma)
    n_j, n_t = j.train(j.get_hyp()), t.train(t.get_hyp())
    np.testing.assert_allclose(n_t, n_j, rtol=1e-7)
    np.testing.assert_allclose(t.get_hyp(), j.get_hyp(), atol=1e-4)


def test_qr_solver_is_plain_masked(prob, monkeypatch):
    """A QR BucketedGP at this N is plain masked in both packages (no warm
    start: _in_stream_regime needs the Cholesky solver), and its masked
    NLL and objective carry no dense-solver budget guard: with a 1-byte
    budget GP's NLL raises and BucketedGP's computes gp_tpu's value."""
    X, y = prob[0], prob[1]
    hyp = np.array([0.2, -0.1, 0.3, 0.1, np.log(0.1), 0.05])
    monkeypatch.setenv("GP_TPU_HBM_BYTES", "1")
    t = BucketedGP(X, y, bucket=BUCKET, solver="qr", device="cpu")
    j = JB(X, y, bucket=BUCKET, solver="qr")
    assert not t._in_stream_regime() and not j._in_stream_regime()
    with pytest.raises(NotImplementedError, match="solver 'qr'"):
        te.nll(SE, t._tensor(hyp), t._x, t._y, T_QR)
    np.testing.assert_allclose(t.nll(hyp), j.nll(hyp), rtol=1e-10)
    xp, ysp = np.asarray(j._xp), np.asarray(j._ysp)
    vec = j._hyp_to_std(hyp)
    fj, gj = je.objective_vg_masked(SE_ARD, False, jnp.asarray(vec),
                                    jnp.asarray(xp), jnp.asarray(ysp), N,
                                    J_QR)
    ft, gt = t._objective_closure()(t._tensor(vec))
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-10)
    np.testing.assert_allclose(_n(gt), np.asarray(gj), rtol=1e-7,
                               atol=1e-7 * np.abs(np.asarray(gj)).max())


def test_checkpoints_load_both_ways(prob, trained, tmp_path):
    """A trained BucketedGP at this N: the port's file in gp_tpu and
    gp_tpu's in the port, factor and invKys bit for bit, no
    refactorization; model_from_state builds it at this N."""
    (j, _, _), (t, _, _) = trained
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tck.save_model(t, pt)
    jck.save_model(j, pj)
    jt = jck.load_model(pt)
    tj = tck.load_model(pj, device="cpu")
    for saved, loaded in ((t._post, jt._post), (j._post, tj._post)):
        for a, b in zip(saved, loaded, strict=True):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert type(tj) is BucketedGP and tj.capacity == CAP and tj.trained
    assert tj._post_aux is None and jt._post_aux is None
    np.testing.assert_allclose(_n(tj.batch_predict_y(prob[2])),
                               j.batch_predict_y(prob[2]), rtol=1e-10,
                               atol=1e-10)
    m = model_from_state({"model": "BucketedGP", "x": prob[0], "y": prob[1],
                          "bucket": BUCKET, "hyps": t.get_hyp()}, "cpu")
    assert m.capacity == CAP and m._in_stream_regime()
