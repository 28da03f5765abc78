"""gp_tpu_torch's stream regime (N >= _STREAM_MIN_N) against gp_tpu's, on
the CPU in float64 unless said otherwise.

The threshold is lowered in both packages for the whole module (to
STREAM_N = 100 rows), as gp_tpu's own tests/test_slabbed.py does, so that
GP models of 128 rows are in the stream regime and their 64-row warm-start
subsets are not.  One gp_tpu stream fit and one port stream fit from the
defaults are shared by the tests (`fits`).  Tolerances: NLL rtol 1e-10
and gradients rtol 1e-7 (the bounds tests/test_golden.py holds gp_tpu
to); the posterior's scalars and invKys, and the predictions, rtol 1e-9;
fitted hyps atol 1e-4.  The Hutchinson probes are gp_tpu's own draws,
jax.random.bernoulli(PRNGKey(seed), 0.5, (n, probes)), passed to the port
as `z`; where the port draws its own (set_k_streamed inside train()),
the logdet correction tr(E) differs by the two probe sets' estimates of a
~1e-14 trace, far below the tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_tpu
from gp_tpu.models import exact as je
from gp_tpu_torch import GP as TGP
from gp_tpu_torch.models import exact as te
from gp_tpu_torch.ops.kernels import get_kernel

STREAM_N = 100


@pytest.fixture(scope="module", autouse=True)
def stream_threshold():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(je, "_STREAM_MIN_N", STREAM_N)
        mp.setattr(te, "_STREAM_MIN_N", STREAM_N)
        yield


def _problem(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, d))
    y = (np.sin(2 * X[:, 0]) + 0.5 * np.cos(3 * X[:, 1])
         + 0.1 * rng.standard_normal(n))
    return X, y


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a, np.float64), dtype=dtype)


def _n(t):
    return t.detach().cpu().numpy()


def _probes(n, probes=16, seed=0):
    z = jax.random.bernoulli(jax.random.PRNGKey(seed), 0.5, (n, probes))
    return torch.from_numpy(np.asarray(z, np.float64) * 2.0 - 1.0)


def _hyp(kernel, X, y, shift=0.2, seed=0):
    h = np.asarray(gp_tpu.GP(X, y, kernel=kernel).get_default_hyps())
    h = h + np.random.default_rng(seed).uniform(-shift, shift, h.shape)
    h[-2] = np.log(0.1)
    return h


@pytest.fixture(scope="module")
def fits(stream_threshold):
    """gp_tpu's and the port's GP(X, y).train() at 128 rows from the
    defaults (the subset-MLE warm start at m = 64), with what train()
    printed on stderr."""
    X, y = _problem(128, 3, seed=1)
    import contextlib
    import io
    out = {}
    for name, make in (("j", lambda: gp_tpu.GP(X, y)),
                       ("t", lambda: TGP(X, y, device="cpu"))):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            gp = make()
            assert gp._in_stream_regime()
            out[name] = (gp, gp.train(), err.getvalue())
    out["Xs"] = _problem(9, 3, seed=2)[0]
    return out


@pytest.mark.parametrize("kernel", ["se_ard", "matern52"])
@pytest.mark.parametrize("tile", [32, 40])
def test_nll_vg_streamed_matches_gp_tpu(kernel, tile, monkeypatch):
    """At a dividing tile (32: the T = L^-1 form) and a non-dividing one
    (40: identity-column solves); the port's dense nll_vg_raw below the
    threshold and, with the threshold lowered past N, the form
    objective_vg picks (the dense one with the stream regime's alpha)
    against the same numbers."""
    X, y = _problem(96, 3, seed=4)
    hyp = _hyp(kernel, X, y)
    spec = gp_tpu.GP(X, y, kernel=kernel).kernel
    fj, gj = je.nll_vg_streamed(spec, jnp.asarray(hyp), jnp.asarray(X),
                                jnp.asarray(y), tile=tile)
    fj, gj = float(fj), np.asarray(gj)
    tspec = TGP(X, y, kernel=kernel, device="cpu").kernel
    x, yt = _t(X), _t(y)
    forms = {"streamed": te.nll_vg_streamed(tspec, _t(hyp), x, yt,
                                            tile=tile),
             "dense": te.nll_vg_raw(tspec, _t(hyp), x, yt)}
    monkeypatch.setattr(te, "_STREAM_MIN_N", 32)
    for budget, route in (("1", "streamed"), (str(2 ** 40), "dense")):
        monkeypatch.setenv("GP_TPU_HBM_BYTES", budget)
        assert te.use_streamed_vg(tspec, x) == (route == "streamed")
        forms[f"objective_vg ({route})"] = te.objective_vg(
            tspec, False, _t(hyp), x, yt)
    for form, (f, g) in forms.items():
        np.testing.assert_allclose(float(f), fj, rtol=1e-10, err_msg=form)
        np.testing.assert_allclose(_n(g), gj, rtol=1e-7,
                                   atol=1e-7 * np.max(np.abs(gj)),
                                   err_msg=form)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_refined_terms_match_gp_tpu(dtype):
    """_refined_terms and nll_refined on gp_tpu's probes.  float64: rtol
    1e-10.  float32: both refined NLLs within 2e-6 relative of the f64
    value (a plain f32 NLL is off by ~1e-5 here), and of each other."""
    X, y = _problem(128, 3, seed=5)
    hyp = _hyp("se_ard", X, y)
    spec = gp_tpu.GP(X, y).kernel
    tspec = TGP(X, y, device="cpu").kernel
    z = _probes(128, seed=3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj, yj, hj = (jnp.asarray(a, jdt) for a in (X, y, hyp))
    xt, yt, ht = _t(X, tdt), _t(y, tdt), _t(hyp, tdt)
    vj = float(je.nll_refined(spec, hj, xj, yj, tile=32, seed=3))
    vt = float(te.nll_refined(tspec, ht, xt, yt, tile=32, z=z))
    if dtype == "float64":
        np.testing.assert_allclose(vt, vj, rtol=1e-10)
        Lj = je._factor_k_noise(spec, hj[:-2], xj, jnp.exp(2 * hj[-2]), 32)
        Lt = te._factor_k_noise(tspec, ht, xt)
        aj, ldj, nj = je._refined_terms(spec, hj, xj, yj, Lj, None, 32, 16,
                                        3)
        at, ldt, nt, tr_e2 = te._refined_terms(tspec, ht, xt, yt, Lt, None,
                                               32, z=z)
        assert 0.0 <= float(tr_e2) <= 1e-20        # E ~ eps: no warning
        np.testing.assert_allclose(_n(at), np.asarray(aj), rtol=1e-10)
        np.testing.assert_allclose(float(ldt), float(ldj), rtol=1e-10)
        np.testing.assert_allclose(float(nt), float(nj), rtol=1e-10)
        np.testing.assert_allclose(float(nt), vt, rtol=1e-12)
    else:
        v64 = float(te.nll_refined(tspec, _t(hyp), _t(X), _t(y), z=z))
        raw32 = float(te.nll_raw(tspec, ht, xt, yt))
        for v in (vj, vt):
            assert abs(v - v64) <= 2e-6 * abs(v64), (v, v64, raw32)
        np.testing.assert_allclose(vt, vj, rtol=2e-6)


def test_refined_terms_second_order_and_warning(monkeypatch, capsys):
    """tr_e2 against the exact tr(E^2) where L factors K + delta I in
    place of K, so that E = -delta (K + delta I)^-1 is far from 0: within
    20 % on 1024 probes (their spread is ~4 %).  set_k_streamed with that
    factor warns on stderr that its refined NLL is first order; with the
    true factor it prints nothing."""
    X, y = _problem(96, 3, seed=7)
    hyp = _hyp("se_ard", X, y)
    tspec, ht, xt, yt = get_kernel("se_ard"), _t(hyp), _t(X), _t(y)
    delta = 10 * np.exp(2 * hyp[-2])
    shifted = ht.clone()
    shifted[-2] = 0.5 * np.log(np.exp(2 * hyp[-2]) + delta)
    Ls = te._factor_k_noise(tspec, shifted, xt)
    E = -delta * np.linalg.inv(_n(Ls @ Ls.T))
    z = te.rademacher_probes(96, 1024, 4, torch.float64, "cpu")
    tr_e2 = float(te._refined_terms(tspec, ht, xt, yt, Ls, z=z)[3])
    exact = float(np.trace(E @ E))
    assert abs(tr_e2 / exact - 1.0) <= 0.2, (tr_e2, exact)

    te.set_k_streamed(tspec, ht, xt, yt, tile=32)
    assert capsys.readouterr().err == ""
    orig = te._factor_k_noise
    monkeypatch.setattr(te, "_factor_k_noise", lambda k, h, x: orig(
        k, torch.cat([h[:-2], shifted[-2:-1], h[-1:]]), x))
    _, aux, _ = te.set_k_streamed(tspec, ht, xt, yt, tile=32)
    err = capsys.readouterr().err
    assert err.startswith("[gp_tpu_torch] set_k_streamed: the refined NLL "
                          f"{aux['nll_refined']:.6f} may be off by"), err


def test_set_k_streamed_at_fitted_hyps(fits):
    gj, _, _ = fits["j"]
    X, y = np.asarray(gj._x), np.asarray(gj._y)
    hyp = np.asarray(gj.get_hyp())
    hj, auxj, ivj = je.set_k_streamed(gj.kernel, jnp.asarray(hyp),
                                      jnp.asarray(X), jnp.asarray(y))
    ht, auxt, ivt = te.set_k_streamed(get_kernel("se_ard"), _t(hyp),
                                      _t(X), _t(y), z=_probes(128))
    np.testing.assert_array_equal(_n(ht), np.asarray(hj))
    for k in ("logdet", "nll_refined"):
        np.testing.assert_allclose(auxt[k], auxj[k], rtol=1e-9)
    np.testing.assert_allclose(_n(ivt), np.asarray(ivj), rtol=1e-9)


# fixed upper limits on the rescued posterior's gaps to gp_tpu, relative:
# logdet, refined NLL, invKys (test_set_k_streamed_rescue_matches_gp_tpu)
RESCUE_LIMIT = np.array([1e-5, 1e-3, 1e-2])


def test_set_k_streamed_rescue_matches_gp_tpu(capsys):
    """A singular K (every row twice) at sigma_n = 1e-12, as
    test_exact_gp.py's test_set_k_streamed_matches_set_k: the same
    candidate (log_sn bit for bit) and the same stderr message.  The
    posterior there sits on the conditioning floor (sn2 ~ N eps sf2, the
    schedule's design: cond(K) ~ 1/eps), where rounding alone moves the
    logdet, the refined NLL and invKys by ~1e-6, ~1e-4 and ~1e-3
    relative; so they are held to ten times the largest gap that three
    row permutations of the same problem give in the port itself, and
    never beyond RESCUE_LIMIT (the gaps measured, 2.9e-6, 2.0e-4 and
    7.7e-4, with headroom)."""
    rng = np.random.default_rng(1)
    X = np.repeat(rng.standard_normal((48, 4)), 2, axis=0)
    y = rng.standard_normal(96)
    hyp = np.asarray(gp_tpu.GP(X, y).get_default_hyps())
    hyp[-2] = np.log(1e-12)
    spec = gp_tpu.GP(X, y).kernel
    hj, auxj, ivj = je.set_k_streamed(spec, jnp.asarray(hyp),
                                      jnp.asarray(X), jnp.asarray(y),
                                      tile=32)
    msg_j = capsys.readouterr().err
    tspec, z = get_kernel("se_ard"), _probes(96)
    ht, auxt, ivt = te.set_k_streamed(tspec, _t(hyp), _t(X), _t(y),
                                      tile=32, z=z)
    msg_t = capsys.readouterr().err
    assert float(hj[-2]) > hyp[-2]                 # the rescue ran
    np.testing.assert_array_equal(_n(ht), np.asarray(hj))
    assert msg_j.startswith("[gp_tpu] set_k_streamed: noise raised")
    assert msg_t == msg_j.replace("[gp_tpu]", "[gp_tpu_torch]", 1)

    def gaps(aux, iv):
        return np.array([abs(aux[k] / auxt[k] - 1.0)
                         for k in ("logdet", "nll_refined")]
                        + [np.max(np.abs(iv - _n(ivt)))
                           / np.max(np.abs(_n(ivt)))])

    spread = np.zeros(3)
    for seed in (1, 2, 3):
        p = np.random.default_rng(seed).permutation(96)
        hp, auxp, ivp = te.set_k_streamed(tspec, _t(hyp), _t(X[p]),
                                          _t(y[p]), tile=32, z=z[p])
        assert float(hp[-2]) == float(ht[-2])
        spread = np.maximum(spread, gaps(auxp, _n(ivp)[np.argsort(p)]))
    capsys.readouterr()
    gap = gaps(auxj, np.asarray(ivj))
    assert np.all(gap <= 10 * spread), (gap, spread)
    assert np.all(gap <= RESCUE_LIMIT), (gap, RESCUE_LIMIT)


def test_set_k_streamed_exhaustion_raises():
    """A NaN length scale fails every candidate: both raise."""
    X, y = _problem(64, 2, seed=6)
    hyp = np.asarray(gp_tpu.GP(X, y).get_default_hyps())
    hyp[0] = np.nan
    match = "failed after 32 rescue attempts"
    with pytest.raises(RuntimeError, match=match):
        je.set_k_streamed(gp_tpu.GP(X, y).kernel, jnp.asarray(hyp),
                          jnp.asarray(X), jnp.asarray(y))
    with pytest.raises(RuntimeError, match=match):
        te.set_k_streamed(get_kernel("se_ard"), _t(hyp), _t(X), _t(y))


def test_streamed_predictions_match_gp_tpu(fits):
    gj, _, _ = fits["j"]
    Xs = fits["Xs"]
    X, y = np.asarray(gj._x), np.asarray(gj._y)
    hyp, iv = np.asarray(gj._hyps), np.asarray(gj._post[-1])
    mj, sj = je.predict_streamed(gj.kernel, jnp.asarray(hyp),
                                 jnp.asarray(X), jnp.asarray(iv),
                                 jnp.asarray(Xs))
    s2j, gs2j = je.predict_s2_with_grad_streamed(
        gj.kernel, jnp.asarray(hyp), jnp.asarray(X), jnp.asarray(Xs))
    spec = get_kernel("se_ard")
    mt, st = te.predict_streamed(spec, _t(hyp), _t(X), _t(iv), _t(Xs))
    s2t, gs2t = te.predict_s2_with_grad_streamed(spec, _t(hyp), _t(X),
                                                 _t(Xs))
    for a, b in ((mt, mj), (st, sj), (s2t, s2j)):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-9)
    gs2j = np.asarray(gs2j)
    np.testing.assert_allclose(_n(gs2t), gs2j, rtol=1e-7,
                               atol=1e-7 * np.max(np.abs(gs2j)))


def test_train_in_stream_regime_matches_gp_tpu(fits):
    """GP(X, y).train() from the defaults: the same warm start (the
    subset rows and their fit, as the stderr line prints them), the
    refined NLL returned, the hyps, the model's predictions."""
    (gj, vj, errj), (gt, vt, errt) = fits["j"], fits["t"]
    warm = [ln for ln in errj.splitlines() if "subset-MLE" in ln]
    assert warm and ln_port(warm[0]) in errt
    np.testing.assert_allclose(vt, vj, rtol=1e-9)
    assert vt == gt._nll_from_posterior() == gt._post_aux["nll_refined"]
    assert len(gt._post) == 1
    with pytest.raises(RuntimeError, match="cache no factor"):
        gt._factors()
    np.testing.assert_allclose(gt.get_hyp(), np.asarray(gj.get_hyp()),
                               atol=1e-4)
    Xs = fits["Xs"]
    for name in ("batch_predict", "batch_predict_s2", "batch_predict_y",
                 "batch_predict_s2_with_grad"):
        rj = getattr(gj, name)(Xs)
        rt = getattr(gt, name)(Xs)
        for a, b in zip(*((rt, rj) if isinstance(rt, tuple)
                          else ((rt,), (rj,)))):
            b = np.asarray(b)
            np.testing.assert_allclose(_n(a), b, rtol=1e-5,
                                       atol=1e-5 * np.max(np.abs(b)))


def ln_port(line):
    return line.replace("[gp_tpu]", "[gp_tpu_torch]", 1)


def test_stream_checkpoint_loads_across_packages(fits, tmp_path):
    """A stream model's file ((invKys,) and post_aux) loads in either
    package with its predictions equal."""
    from gp_tpu.utils.checkpoint import load_model as j_load
    (gj, _, _), (gt, _, _) = fits["j"], fits["t"]
    Xs = fits["Xs"]
    for src, load, path in ((gt, j_load, tmp_path / "port.npz"),
                            (gj, lambda p: TGP.load(p, device="cpu"),
                             tmp_path / "gp_tpu.npz")):
        src.save(str(path))
        dst = load(str(path))
        assert dst._post_aux == src._post_aux and len(dst._post) == 1
        for a, b in zip(dst.batch_predict(Xs), src.batch_predict(Xs)):
            np.testing.assert_allclose(np.asarray(_n(a) if isinstance(
                a, torch.Tensor) else a), np.asarray(
                _n(b) if isinstance(b, torch.Tensor) else b), rtol=1e-12)


def test_nll_vg_streamed_breakdown_matches_gp_tpu(monkeypatch, capfd):
    """Under GP_TPU_DEBUG=1 and GP_TPU_VERBOSE_OPT=1 both print one
    "[GP_TPU_DEBUG] nll_vg_streamed: ..." line with the same keys, their
    terms at rtol 1e-10, and the port's adding up to its value."""
    import re
    monkeypatch.setenv("GP_TPU_DEBUG", "1")
    monkeypatch.setenv("GP_TPU_VERBOSE_OPT", "1")
    X, y = _problem(96, 3, seed=4)
    hyp = _hyp("se_ard", X, y)
    je.nll_vg_streamed(gp_tpu.GP(X, y).kernel, jnp.asarray(hyp),
                       jnp.asarray(X), jnp.asarray(y),
                       tile=32)[0].block_until_ready()
    text_j = capfd.readouterr().out
    f, _ = te.nll_vg_streamed(get_kernel("se_ard"), _t(hyp), _t(X), _t(y),
                              tile=32)
    text_t = capfd.readouterr().out

    def terms(text):
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("[GP_TPU_DEBUG] nll_vg_streamed: ")]
        assert len(lines) == 1, text
        return re.findall(r"(\w+)=(\S+)", lines[0].split(": ", 1)[1])

    tj, tt = terms(text_j), terms(text_t)
    assert [k for k, _ in tt] == [k for k, _ in tj] == [
        "nlz", "data_fit", "half_logdet", "norm_const"]
    vt = [float(v) for _, v in tt]
    np.testing.assert_allclose(vt, [float(v) for _, v in tj], rtol=1e-10)
    np.testing.assert_allclose(sum(vt[1:]), vt[0], rtol=1e-12)
    np.testing.assert_allclose(vt[0], float(f), rtol=1e-12)
