"""gp_tpu_torch's distributed layer (parallel/) under torch.distributed
against gp_tpu's on its 8-virtual-device CPU mesh (tests/conftest.py), in
float64.

One gloo world of 2 and one of 4 processes (parallel.mesh.spawn, a
FileStore rendezvous in a temporary directory, killed on a hang), each
running tests/torch_dist_programs.py once; the processes return numpy
arrays, compared here with gp_tpu's functions at n_dev = 2, block 4
(gp_tpu's programs are compiled at that one mesh shape; the 4-process
world's values are the same function's).  N = 60 is not a multiple of
P B = 8 or 16: the identity padding is on every path.

Bounds: the factor, L^-1 and K^-1 rows at 1e-12 (relative to their
largest entry), the NLL at rtol 1e-10 and its gradient at 1e-7, the
rescues to the same noise and jitter, predictions at 1e-10.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gp_tpu
from gp_tpu import SE_ARD
from gp_tpu.models import exact as je
from gp_tpu.models.base import default_hyps
from gp_tpu.parallel import pgp, pmultistart, psparse
from gp_tpu.parallel.mesh import make_mesh
from gp_tpu.utils import checkpoint as jck
from gp_tpu_torch.parallel.mesh import spawn

import torch_dist_programs as programs

pytestmark = pytest.mark.dist

WORLDS = (2, 4)
BLOCK = programs.BLOCK
TIMEOUT = 120


def _ms_j(x):
    """quadratic_vg's function in jax."""
    return (jnp.sum((x - 2.2) ** 2) * 0.05
            + jnp.sum(1.0 - jnp.cos(2.5 * (x - 2.2))))


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(7)
    X = rng.uniform(-2, 2, (60, 3))
    y = np.sin(X[:, 0]) - 0.3 * X[:, 1] ** 2 + 0.05 * rng.standard_normal(60)
    Xd = X.copy()
    Xd[50:] = X[:10]                      # duplicated rows: a rescue
    hyp = default_hyps(SE_ARD, X, y, 1e-3, False)
    hyp = hyp + np.array([0.1, -0.2, 0.3, 0.1, 1.0, 0.0])
    g = gp_tpu.GP(X, y)
    lb, ub = g._std_bounds()
    key = jax.random.PRNGKey(3)
    ms_lb, ms_ub = np.full(4, -5.0), np.full(4, 5.0)
    return {
        "X": X, "y": y, "Xd": Xd, "yd": np.sin(Xd[:, 0]), "hyp": hyp,
        "hyp_dup": np.array([0.0, 0.0, 0.0, 0.0, -30.0, 0.0]),
        "xs": rng.uniform(-2, 2, (5, 3)), "U": X[-8:], "jitter": 1e-6,
        # duplicated inducing rows: Kuu is singular, and the jitter
        # doubles from 1e-20 until it factors
        "U_dup": X[[50, 51, 52, 50, 53, 51]], "hyp_sparse": hyp,
        "jitter_sparse": prob_jitter_sparse(),
        "ms_lb": ms_lb, "ms_ub": ms_ub, "ms_x0": np.full(4, -1.0),
        "ms_n": 4, "ms_key": key,
        "ms_draws": np.asarray(jax.random.uniform(key, (3, 4), jnp.float64)),
        "ys": (y - y.mean()) / y.std(ddof=1), "lb": lb, "ub": ub,
        "ms_vec0": np.clip(g._hyp_to_std(hyp), lb, ub),
    }


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("checkpoints")
    return {"gp_tpu": str(d / "gp_tpu_dist.npz"),
            **{P: str(d / f"port{P}.npz") for P in WORLDS}}


@pytest.fixture(scope="module")
def worlds(prob, files):
    """{P: future of each process's {"world", "train"} results}: the two
    worlds start at once and run beside gp_tpu's references (the
    2-process one waits for gp_tpu_file's checkpoint)."""
    prob_np = {k: v for k, v in prob.items() if k != "ms_key"}
    pool = ThreadPoolExecutor(len(WORLDS))
    futures = {P: pool.submit(spawn, programs.run, P, "cpu", TIMEOUT,
                              (prob_np, files[P],
                               files["gp_tpu"] if P == 2 else None))
               for P in WORLDS}
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def gp_tpu_file(prob, files):
    """A gp_tpu GP with a 2-device distributed posterior at hyp, saved
    (written under another name, then renamed: the processes wait for
    it)."""
    X, y = prob["X"], prob["y"]
    g = gp_tpu.GP(X, y)
    mesh = make_mesh(2)
    h, L, a, ok = pgp.pset_k(SE_ARD, jnp.asarray(prob["hyp"]), X, y, mesh,
                             block=BLOCK)
    assert ok
    g._hyps, g._post, g._post_dist, g._trained = h, None, \
        (mesh, BLOCK, L, a), True
    tmp = files["gp_tpu"] + ".part.npz"
    jck.save_model(g, tmp)
    os.replace(tmp, files["gp_tpu"])
    return files["gp_tpu"]


def _world(worlds, P, key, part="world"):
    res = worlds[P].result(timeout=3 * TIMEOUT)
    return [r[part][key] for r in res]


@pytest.fixture(scope="module")
def ref(prob, gp_tpu_file):
    """gp_tpu's values on a 2-device mesh."""
    mesh = make_mesh(2)
    X, y, xs = (jnp.asarray(prob[k]) for k in ("X", "y", "xs"))
    hyp = jnp.asarray(prob["hyp"])
    out = {"pnll": pgp.pnll_vg(SE_ARD, hyp, X, y, mesh, block=BLOCK)}
    h, L, a, ok = pgp.pset_k(SE_ARD, hyp, X, y, mesh, block=BLOCK)
    out["pset_k"] = (h, L, a, ok)
    out["ppredict"] = pgp.ppredict(SE_ARD, h, X, L, a, xs, mesh, block=BLOCK)
    out["ppredict_with_grad"] = pgp.ppredict_with_grad(SE_ARD, h, X, L, a,
                                                       xs, mesh, block=BLOCK)
    out["pset_k_rescue"] = pgp.pset_k(
        SE_ARD, jnp.asarray(prob["hyp_dup"]), jnp.asarray(prob["Xd"]),
        jnp.asarray(prob["yd"]), mesh, block=BLOCK)
    U = jnp.asarray(prob["U"])
    for model in ("fitc", "vfe"):
        f, g = jax.value_and_grad(lambda hh: psparse.pnll_sparse(
            model, SE_ARD, hh, X, y, U, prob["jitter"], mesh))(hyp)
        post = psparse.pset_k_sparse(model, SE_ARD, hyp, X, y, U,
                                     prob["jitter"], mesh)
        out[model] = (f, g, post)
    out["pmultistart"] = pmultistart.pmultistart_lbfgsb(
        lambda v: jax.value_and_grad(_ms_j)(v), prob["ms_key"],
        jnp.asarray(prob["ms_lb"]), jnp.asarray(prob["ms_ub"]),
        jnp.asarray(prob["ms_x0"]), make_mesh(2, axis_name="starts"),
        n_starts=prob["ms_n"], max_evals=60)
    return out


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


@pytest.mark.parametrize("P", WORLDS)
def test_pchol_factor_and_inverse_rows(worlds, gp_tpu_file, ref, P):
    h, L, a, ok = ref["pset_k"]
    Lj = np.asarray(L)                                 # (nbl, 2, B, N_pad)
    Lnat = Lj.reshape(-1, Lj.shape[-1])                # natural row order
    for hp, Lg, ap, okp in _world(worlds, P, "pset_k"):
        assert okp and bool(ok)
        np.testing.assert_array_equal(hp, np.asarray(h))
        # the gathered factor (P, nbl, B, N_pad) in natural order
        _close(Lg.transpose(1, 0, 2, 3).reshape(-1, Lg.shape[-1]), Lnat,
               1e-12)
        _close(ap, np.asarray(a), 1e-10)
    n_pad = Lnat.shape[0]
    W_ref = np.linalg.inv(Lnat)
    for W, kinv, kinv_full in zip(_world(worlds, P, "W"),
                                  _world(worlds, P, "kinv"),
                                  _world(worlds, P, "kinv_full")):
        _close(np.tril(W), W_ref, 1e-12)
        assert np.array_equal(W, np.tril(W))
        _close(kinv, W_ref.T @ W_ref, 1e-12)
        _close(kinv_full, W_ref.T @ W_ref, 1e-12)
    assert n_pad % (P * BLOCK) == 0 and n_pad > 60


@pytest.mark.parametrize("P", WORLDS)
def test_pnll_vg_matches_gp_tpu(worlds, ref, P):
    fj, gj = ref["pnll"]
    vals = _world(worlds, P, "pnll")
    for f, g in vals:
        np.testing.assert_allclose(f, float(fj), rtol=1e-10)
        _close(g, gj, 1e-7)
    # replicated: every process holds the same value and gradient
    assert all(f == vals[0][0] and np.array_equal(g, vals[0][1])
               for f, g in vals)


@pytest.mark.parametrize("P", WORLDS)
def test_pset_k_rescue_matches_gp_tpu(worlds, ref, P):
    hj, _, aj, okj = ref["pset_k_rescue"]
    assert bool(okj) and float(hj[-2]) > -30.0
    for h, a, ok in _world(worlds, P, "pset_k_rescue"):
        assert ok
        np.testing.assert_allclose(h[-2], float(hj[-2]), rtol=1e-12)
        assert np.all(np.isfinite(a))


@pytest.mark.parametrize("P", WORLDS)
def test_ppredict_matches_gp_tpu(worlds, ref, P):
    for got in _world(worlds, P, "ppredict"):
        for a, b in zip(got, ref["ppredict"]):
            _close(a, b, 1e-10)
    for got in _world(worlds, P, "ppredict_with_grad"):
        for a, b in zip(got, ref["ppredict_with_grad"]):
            _close(a, b, 1e-10)


@pytest.mark.parametrize("model", ["fitc", "vfe"])
@pytest.mark.parametrize("P", WORLDS)
def test_pnll_sparse_matches_gp_tpu(worlds, ref, P, model):
    """The value, and the hand-assembled gradient against jax.grad through
    gp_tpu's psum (a naive all_reduce backward would make it P times too
    large); pset_k_sparse's posterior.  The jitter doubling on duplicated
    inducing rows: Kuu and A are singular there, so where the doubling
    stops is decided by the factorizations' rounding (gp_tpu's LAPACK and
    torch's stop at different steps, as do one and several threads);
    every process must take the same steps and end with a valid factor."""
    fj, gj, (Luu, LA, alpha, jit, ok) = ref[model]
    rescued = []
    for f, fv, g, post, rescue in _world(worlds, P, model):
        np.testing.assert_allclose(f, float(fj), rtol=1e-10)
        np.testing.assert_allclose(fv, float(fj), rtol=1e-10)
        _close(g, gj, 1e-7)
        assert post[4] and bool(ok)
        np.testing.assert_allclose(post[3], float(jit), rtol=1e-12)
        for a, b in zip(post[:3], (Luu, LA, alpha)):
            _close(a, b, 1e-10)
        assert rescue[1] and rescue[0] > prob_jitter_sparse()
        rescued.append(rescue[0])
    assert len(set(rescued)) == 1


def prob_jitter_sparse():
    return 1e-20


@pytest.mark.parametrize("P", WORLDS)
def test_pmultistart_matches_gp_tpu(worlds, ref, P):
    rj = ref["pmultistart"]
    for x, f, all_f, all_x in _world(worlds, P, "pmultistart"):
        np.testing.assert_allclose(all_f, np.asarray(rj.all_f), rtol=1e-9)
        np.testing.assert_allclose(all_x, np.asarray(rj.all_x), atol=1e-7)
        np.testing.assert_allclose(f, float(rj.f), rtol=1e-9)
        np.testing.assert_allclose(x, np.asarray(rj.x), atol=1e-7)


@pytest.mark.parametrize("P", WORLDS)
def test_train_distributed_matches_gp_tpu(worlds, prob, P):
    """From a fixed start: the final f at rtol 1e-9 of gp_tpu's fit from
    the same start, on every process; the posterior's predictions."""
    gj = gp_tpu.GP(prob["X"], prob["y"])
    fj = gj.train(init_hyps=prob["hyp"])
    res = worlds[P].result(timeout=3 * TIMEOUT)
    for r in res:
        t = r["train"]
        np.testing.assert_allclose(t["f"], fj, rtol=1e-9)
        np.testing.assert_allclose(t["hyp"], np.asarray(gj.get_hyp()),
                                   rtol=1e-5, atol=1e-5)
        assert t["f"] == res[0]["train"]["f"]
        mu, s2 = gj.batch_predict(prob["xs"])
        _close(t["pred"][0], mu, 1e-6)
        _close(t["pred"][1], s2, 1e-6)


@pytest.mark.parametrize("P", WORLDS)
def test_fitc_train_distributed(worlds, P):
    """FITC.train_distributed: every process returns the same NLL, the
    single-process FITC's at the fitted hyps (rtol 1e-9)."""
    res = worlds[P].result(timeout=3 * TIMEOUT)
    for r in res:
        nll, single, evals = r["train"]["fitc"]
        np.testing.assert_allclose(nll, single, rtol=1e-9)
        assert nll == res[0]["train"]["fitc"][0] and evals > 1


@pytest.mark.parametrize("P", WORLDS)
def test_checkpoint_round_trip(worlds, P):
    """save_model gathers the factor; load_model leaves it pending until
    restore_distributed, whose predictions are the saved model's, bit for
    bit."""
    for r in worlds[P].result(timeout=3 * TIMEOUT):
        t = r["train"]
        assert t["pending"]
        for a, b in zip(t["reloaded"], t["pred"][:2]):
            np.testing.assert_array_equal(a, b)


def test_gp_tpu_distributed_file_restores_in_port(worlds, ref):
    """gp_tpu's 2-device distributed save_model file, restored on a
    2-process mesh: predictions within 1e-10 of gp_tpu's."""
    mu, s2 = ref["ppredict"]
    for r in worlds[2].result(timeout=3 * TIMEOUT):
        a, b = r["train"]["gp_tpu_file"]
        _close(a, mu, 1e-10)
        _close(b, s2, 1e-10)


@pytest.mark.parametrize("P", WORLDS)
def test_pfit_multistart(worlds, prob, P):
    """The 2-D (starts, rows) multi-start's best f is the better of the two
    starts' gp_tpu fits (exact.fit, one device)."""
    fs = []
    for v0 in (prob["ms_vec0"], prob["ms_vec0"] + 0.3):
        res = je.fit(SE_ARD, False, jnp.asarray(prob["X"]),
                     jnp.asarray(prob["ys"]), jnp.asarray(v0),
                     jnp.asarray(prob["lb"]), jnp.asarray(prob["ub"]))
        fs.append(float(res.f))
    for r in worlds[P].result(timeout=3 * TIMEOUT):
        x, f = r["train"]["pfit_multistart"]
        np.testing.assert_allclose(f, min(fs), rtol=1e-9)


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn(programs.fail_on_rank_1, 2, "cpu", 60)
