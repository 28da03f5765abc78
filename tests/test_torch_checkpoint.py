"""gp_tpu_torch's checkpoints against gp_tpu's file format, on the CPU in
float64: GP, FITC, VFE and BucketedGP, trained and untrained.

A port file loads in the port with its posterior bit for bit and without
refactorizing; a gp_tpu file loads in the port, and a port file in
gp_tpu, with predictions at rtol 1e-10 of the saving model's.  The models
are "trained" by installing a posterior at fixed hyperparameters (each
package's _update_posterior), which is what a checkpoint carries; no fit
runs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_tpu
from gp_tpu.models.bucketed import BucketedGP as JB
from gp_tpu.utils import checkpoint as jck
from gp_tpu_torch import GP
from gp_tpu_torch.models.base import GPBase
from gp_tpu_torch.utils import checkpoint as tck
from gp_tpu_torch.utils.convert import MODELS, gp_from_state, model_from_state

HYP = np.array([0.3, -0.1, 0.2, -2.3, 0.1])    # d = 2 SE-ARD, noise, mean
NAMES = ["GP", "FITC", "VFE", "BucketedGP"]
J_CLASSES = {"GP": gp_tpu.GP, "FITC": gp_tpu.FITC, "VFE": gp_tpu.VFE,
             "BucketedGP": JB}


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    X = rng.uniform(-3, 3, (40, 2))
    y = np.sin(X[:, 0]) * np.cos(X[:, 1]) + 0.05 * rng.standard_normal(40)
    return X, y, rng.uniform(-3, 3, (10, 2))


def _state(name, X, y):
    s = {"model": name, "x": X, "y": y, "hyps": HYP, "dtype": "float64"}
    if name in ("FITC", "VFE"):
        s["inducing"] = X[-8:]
    if name == "BucketedGP":
        s["bucket"] = 16
    return s


def _port(name, X, y, trained):
    """A port model with a posterior at HYP, or one never trained (no
    hyperparameters)."""
    st = _state(name, X, y)
    if trained:
        return gp_from_state(st, device="cpu")
    del st["hyps"]
    return model_from_state(st, device="cpu")


@pytest.fixture(scope="module")
def jmodels(problem):
    """One trained gp_tpu model of each class (shared; never mutated)."""
    X, y, _ = problem
    out = {}
    for name in NAMES:
        kw = {"bucket": 16} if name == "BucketedGP" else {}
        m = J_CLASSES[name](X, y, **kw)
        if name in ("FITC", "VFE"):
            m.set_inducing(X[-8:])
        m._hyps = jnp.asarray(HYP)
        m._update_posterior()
        m._trained = True
        out[name] = m
    return out


def _n(t):
    return t.detach().cpu().numpy()


def _pred(m, Xs):
    """(mu, s2) as numpy, from either package."""
    mu, s2 = m.batch_predict(Xs)
    return tuple(_n(a) if isinstance(a, torch.Tensor) else np.asarray(a)
                 for a in (mu, s2))


def _no_refactor(monkeypatch):
    for cls in MODELS.values():
        monkeypatch.setattr(cls, "_update_posterior", lambda self: (
            pytest.fail("load refactorized")))


@pytest.mark.parametrize("trained", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_port_round_trip(problem, tmp_path, monkeypatch, name, trained):
    X, y, Xs = problem
    m = _port(name, X, y, trained)
    path = str(tmp_path / "m.npz")
    m.save(path)
    _no_refactor(monkeypatch)
    r = GPBase.load(path, device="cpu")
    assert type(r) is type(m) and r.trained == trained
    assert r.kernel.name == m.kernel.name and r.dtype == m.dtype
    assert torch.equal(r._x, m._x) and torch.equal(r._y, m._y)
    if not trained:
        assert r._post is None and r._hyps is None
        return
    assert torch.equal(r._hyps, m._hyps)
    assert len(r._post) == len(m._post)
    for a, b in zip(r._post, m._post):
        assert torch.equal(a, b)
    for a, b in zip(_pred(r, Xs), _pred(m, Xs)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_gp_tpu_file_loads_in_port(problem, jmodels, tmp_path, monkeypatch,
                                   name):
    X, y, Xs = problem
    j = jmodels[name]
    path = str(tmp_path / "j.npz")
    jck.save_model(j, path)
    _no_refactor(monkeypatch)
    t = tck.load_model(path, device="cpu")
    assert type(t).__name__ == name and t.trained
    for a, b in zip(t._post, j._post):
        np.testing.assert_array_equal(_n(a), np.asarray(b))
    for a, b in zip(_pred(t, Xs), _pred(j, Xs)):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_port_file_loads_in_gp_tpu(problem, tmp_path, name):
    X, y, Xs = problem
    t = _port(name, X, y, True)
    path = str(tmp_path / "t.npz")
    tck.save_model(t, path)
    j = jck.load_model(path)
    assert type(j).__name__ == name and j._trained
    if name == "BucketedGP":        # the factor at capacity, gp_tpu's layout
        assert np.asarray(j._post[0]).shape == (48, 48)
    for a, b in zip(_pred(j, Xs), _pred(t, Xs)):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


def test_bucketed_after_absorb_and_seed(problem, tmp_path):
    """A BucketedGP after absorbs (its buffers partly filled) round-trips
    in both packages; the key field is gp_tpu's PRNGKey(seed) and the
    port's search generator carries on where it stopped."""
    X, y, Xs = problem
    t = gp_from_state({**_state("BucketedGP", X[:35], y[:35]), "seed": 5},
                      device="cpu")
    for i in range(35, 38):
        t.absorb(X[i], y[i])
    t.draws.uniform((3,), torch.float64, "cpu")
    path = str(tmp_path / "b.npz")
    t.save(path)
    with np.load(path) as z:
        np.testing.assert_array_equal(z["key"], np.array([0, 5], np.uint32))
    r = GPBase.load(path, device="cpu")
    assert (r.num_train, r.capacity) == (38, 48)
    assert torch.equal(r.draws.uniform((4,), torch.float64, "cpu"),
                       t.draws.uniform((4,), torch.float64, "cpu"))
    j = jck.load_model(path)
    for a, b in zip(_pred(j, Xs), _pred(t, Xs)):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)


def test_gp_tpu_kernel_name_loads_under_its_own_name(problem, tmp_path):
    X, y, Xs = problem
    j = gp_tpu.GP(X, y, kernel="se_iso_xla")
    j._hyps = jnp.asarray(np.array([0.2, 0.1, -2.3, 0.1]))
    j._update_posterior()
    j._trained = True
    path = str(tmp_path / "k.npz")
    jck.save_model(j, path)
    t = GP.load(path, device="cpu")
    assert t.kernel.name == "se_iso_xla"
    for a, b in zip(_pred(t, Xs), _pred(j, Xs)):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)
