"""gp_tpu_torch's BucketedGP against gp_tpu's, on the CPU in float64, on
gp_tpu's own problem shape (tests/test_bucketed.py: N = 45, d = 3, bucket
16, capacity 48).

The masked NLL at rtol 1e-10 and its gradient at rtol 1e-7 (ROADMAP's
bounds); train() and the predictions at gp_tpu's test_matches_plain_gp
tolerances; add_data's frozen and refreshed standardization and capacity
exactly; absorb's three branches (the O(N^2) append, past capacity, a
non-positive pivot) from the same hyperparameters and posterior, factor
and invKys at rtol 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_tpu.models import exact as je
from gp_tpu.models.bucketed import BucketedGP as JB
from gp_tpu import SE_ARD
from gp_tpu_torch import BucketedGP
from gp_tpu_torch.models import exact as te
from gp_tpu_torch.ops.kernels import get_kernel


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(3)
    X = rng.uniform(-2, 2, (45, 3))
    y = np.sin(X[:, 0]) + 0.3 * X[:, 1] + 0.05 * rng.standard_normal(45)
    Xs = rng.uniform(-2, 2, (12, 3))
    new = rng.uniform(-2, 2, (5, 3))
    return X, y, Xs, new, np.sin(new[:, 0]) + 0.3 * new[:, 1]


@pytest.fixture(scope="module")
def trained(prob):
    """One trained model of each package (shared; never mutated)."""
    X, y, _, _, _ = prob
    j, t = JB(X, y, bucket=16), BucketedGP(X, y, bucket=16, device="cpu")
    return j, t, j.train(), t.train()


def _n(t):
    return t.detach().cpu().numpy()


def _pair(prob, trained, n=45):
    """Both packages' models on the first n rows at gp_tpu's fitted hyps,
    each with its own posterior (set_k_masked)."""
    X, y = prob[0][:n], prob[1][:n]
    hyp = trained[0].get_hyp()
    j, t = JB(X, y, bucket=16), BucketedGP(X, y, bucket=16, device="cpu")
    j._hyps = jnp.asarray(hyp)
    t._hyps = t._tensor(hyp)
    for m in (j, t):
        m._update_posterior()
        m._trained = True
    return j, t


def _same_posterior(j, t, Xs, rtol=1e-10):
    assert t.num_train == j.num_train and t.capacity == j.capacity
    for a, b in zip(t._post, j._post):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(_n(a), b, rtol=rtol,
                                   atol=rtol * np.abs(b).max())
    np.testing.assert_allclose(t.get_hyp(), j.get_hyp(), rtol=1e-12)
    mu_j, s2_j = j.batch_predict(Xs)
    mu_t, s2_t = t.batch_predict(Xs)
    np.testing.assert_allclose(_n(mu_t), mu_j, rtol=rtol, atol=rtol)
    np.testing.assert_allclose(_n(s2_t), s2_j, rtol=rtol, atol=rtol)


def test_masked_nll_and_grad_match_gp_tpu(prob, trained):
    X, y = prob[0], prob[1]
    xp = np.zeros((48, 3))
    yp = np.zeros(48)
    xp[:45], yp[:45] = X, y
    hyp = trained[0].get_hyp()
    v_j = je.nll_raw_masked(SE_ARD, jnp.asarray(hyp), jnp.asarray(xp),
                            jnp.asarray(yp), 45)
    f_j, g_j = je.nll_vg_raw_masked(SE_ARD, jnp.asarray(hyp),
                                    jnp.asarray(xp), jnp.asarray(yp), 45)
    k, th = get_kernel("se_ard"), torch.tensor(hyp)
    v_t = te.nll_raw_masked(k, th, torch.from_numpy(xp),
                            torch.from_numpy(yp), 45)
    f_t, g_t = te.nll_vg_raw_masked(k, th, torch.from_numpy(xp),
                                    torch.from_numpy(yp), 45)
    np.testing.assert_allclose(float(v_t), float(v_j), rtol=1e-10)
    np.testing.assert_allclose(float(f_t), float(f_j), rtol=1e-10)
    np.testing.assert_allclose(_n(g_t), np.asarray(g_j), rtol=1e-7,
                               atol=1e-7 * np.abs(np.asarray(g_j)).max())
    # gp_tpu's capacity layout, blockdiag(K, I)
    K_j = je._masked_k(SE_ARD, jnp.asarray(hyp[:4]), jnp.asarray(xp), 45)
    K_t = te._masked_k(k, th[:4], torch.from_numpy(xp), 45)
    np.testing.assert_allclose(_n(K_t), np.asarray(K_j), rtol=1e-12,
                               atol=1e-15)


def test_train_and_predictions_match_gp_tpu(prob, trained):
    """gp_tpu's test_matches_plain_gp tolerances."""
    _, _, Xs, _, _ = prob
    j, t, n_j, n_t = trained
    assert t.capacity == j.capacity == 48
    np.testing.assert_allclose(n_t, n_j, rtol=1e-7)
    mu_j, s2_j = j.batch_predict(Xs)
    mu_t, s2_t = t.batch_predict(Xs)
    np.testing.assert_allclose(_n(mu_t), mu_j, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(_n(s2_t), s2_j, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(_n(t.batch_predict_s2(Xs)), s2_j, rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(_n(t.batch_predict_y(Xs)),
                               j.batch_predict_y(Xs), rtol=1e-7, atol=1e-9)
    y_j, gy_j = j.batch_predict_y_with_grad(Xs[:3])
    y_t, gy_t = t.batch_predict_y_with_grad(Xs[:3])
    np.testing.assert_allclose(_n(y_t), y_j, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(_n(gy_t), gy_j, rtol=1e-6, atol=1e-8)
    s_j, gs_j = j.batch_predict_s2_with_grad(Xs[:2])
    s_t, gs_t = t.batch_predict_s2_with_grad(Xs[:2])
    np.testing.assert_allclose(_n(s_t), s_j, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(_n(gs_t), gs_j, rtol=1e-5, atol=1e-8)


def test_add_data_freezes_then_refreshes_standardization(prob):
    X, y, _, new, y_new = prob
    j = JB(X[:40], y[:40], bucket=16)
    t = BucketedGP(X[:40], y[:40], bucket=16, device="cpu")
    mu0, sigma0 = t._y_mu, t._y_sigma
    assert (t.capacity, mu0, sigma0) == (j.capacity, j._y_mu, j._y_sigma)
    for m in (j, t):
        m.add_data(X[40:45], y[40:45])      # 45 of 48: within capacity
    assert t.capacity == j.capacity == 48 and t.num_train == 45
    assert (t._y_mu, t._y_sigma) == (mu0, sigma0) == (j._y_mu, j._y_sigma)
    np.testing.assert_allclose(_n(t._ys), np.asarray(j._ysp)[:45],
                               rtol=1e-15)
    for m in (j, t):
        m.add_data(new, y_new)              # 50 of 48: the buffers grow
    assert t.capacity == j.capacity == 64 and t.num_train == 50
    assert t._y_mu != mu0
    np.testing.assert_allclose([t._y_mu, t._y_sigma], [j._y_mu, j._y_sigma],
                               rtol=1e-15)
    np.testing.assert_allclose(_n(t._ys), np.asarray(j._ysp)[:50],
                               rtol=1e-15)
    assert not t.trained


def test_absorb_append_then_past_capacity(prob, trained):
    """Three appends in O(N^2) (45 -> 48 = capacity), then one past
    capacity: add_data (the buffers grow, the standardization refreshes)
    and a refactorization at the same hyperparameters."""
    _, _, Xs, new, y_new = prob
    j, t = _pair(prob, trained)
    L0 = t._post[0]
    for i in range(3):
        j.absorb(new[i], y_new[i])
        t.absorb(new[i], y_new[i])
        assert t._post[0] is L0             # the factor is written in place
        _same_posterior(j, t, Xs)
    # the appended factor is the refactorization's, to rounding
    fresh = BucketedGP(t._x, t._y, bucket=16, device="cpu")
    fresh._hyps = t._hyps
    fresh._update_posterior()
    np.testing.assert_allclose(_n(t._post[0]), _n(fresh._post[0]),
                               rtol=1e-10, atol=1e-12)
    mu0 = t._y_mu
    j.absorb(new[3], y_new[3])
    t.absorb(new[3], y_new[3])
    assert t.capacity == 64 and t.num_train == 49 and t.trained
    assert t._y_mu != mu0 and t._y_mu == pytest.approx(j._y_mu, rel=1e-15)
    _same_posterior(j, t, Xs)


def test_absorb_non_positive_pivot_refactorizes(prob, trained):
    """A posterior whose factor is scaled by 0.5 makes the appended pivot
    negative in both packages; both refactorize (set_k_masked)."""
    _, _, Xs, new, y_new = prob
    j, t = _pair(prob, trained)
    j._post = (j._post[0] * 0.5, j._post[1])
    t._post = (t._post[0] * 0.5, t._post[1])
    ok_j = je.append_posterior_masked(
        j.kernel, j._hyps, j._xp, j._yp, 45, j._post[0],
        jnp.asarray(new[0]), jnp.asarray(y_new[0]))[-1]
    ok_t = te.append_posterior_masked(
        t.kernel, t._hyps, t._xp.clone(), t._yp.clone(), 45,
        t._post[0].clone(), t._tensor(new[0]), t._tensor(y_new[0]))[-1]
    assert not bool(ok_j) and not bool(ok_t)
    j.absorb(new[0], y_new[0])
    t.absorb(new[0], y_new[0])
    assert t.num_train == 46 and t.trained
    _same_posterior(j, t, Xs)


def test_absorb_failed_rescue_keeps_the_factor(prob, trained):
    """A point with a NaN coordinate: the appended pivot is not positive
    and the refactorization fails in both packages, which raise.  The
    cached factor is left as it was (its identity row not overwritten),
    as gp_tpu's, which returns copies."""
    _, _, _, new, y_new = prob
    j, t = _pair(prob, trained)
    L_before = t._post[0].clone()
    bad = new[0].copy()
    bad[1] = np.nan
    for m in (j, t):
        with pytest.raises(RuntimeError, match="refusing to cache"):
            m.absorb(bad, y_new[0])
    assert t.num_train == j.num_train == 46
    assert torch.equal(t._post[0], L_before)
    np.testing.assert_allclose(_n(t._post[0]), np.asarray(j._post[0]),
                               rtol=1e-10, atol=1e-12)
