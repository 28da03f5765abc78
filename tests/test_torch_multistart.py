"""gp_tpu_torch's global search against gp_tpu's, on the CPU in float64.

The port's samplers take a draw source; here it replays gp_tpu's
jax.random draws with gp_tpu's key splits (gp_tpu/optim/multistart.py:34,
109-114, 177-188), so the two searches see the same candidates, draw for
draw: best x and best f at rtol 1e-10, the multi-start's every f at rtol
1e-9, and at the model level select_init_hyp's hyps at rtol 1e-9 with the
key split by the gp_tpu model's own _next_key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_tpu
from gp_tpu.optim import multistart as jm
from gp_tpu_torch import GP as TGP
from gp_tpu_torch.models import exact as te
from gp_tpu_torch.optim import multistart as tm


class Replay:
    """A draw source that hands out gp_tpu's draws in the order the port
    asks for them; each draw's kind and shape must match."""

    def __init__(self, draws):
        self.queue = [(k, np.asarray(a)) for k, a in draws]

    def _pop(self, kind, shape):
        k, a = self.queue.pop(0)
        assert k == kind and a.shape == tuple(shape), (k, a.shape, shape)
        return a

    def uniform(self, shape, dtype, device):
        return torch.tensor(self._pop("u", shape), dtype=dtype, device=device)

    def bernoulli(self, p, shape, device):
        assert p == 0.5
        return torch.tensor(self._pop("b", shape), device=device)


def box_draws(key, num, nv):
    """gp_tpu's sample_box draw (multistart.py:34)."""
    return [("u", jax.random.uniform(key, (num, nv), jnp.float64))]


def mvmo_draws(key, num, chunk, nv, archive=25):
    """gp_tpu's mvmo_search draws (multistart.py:177-188, 109-114)."""
    key, k0 = jax.random.split(key)
    out = [("u", jax.random.uniform(k0, (archive - 1, nv), jnp.float64))]
    for kt in jax.random.split(key, max(num // chunk, 1)):
        ku, km, _ = jax.random.split(kt, 3)
        out += [("u", jax.random.uniform(ku, (chunk, nv), jnp.float64)),
                ("b", jax.random.bernoulli(km, 0.5, (chunk, nv)))]
    return out


def _deceptive_j(x):
    """Narrow global basin at 2.2 in a field of local minima (as
    tests/test_mvmo.py), and an INF wall past x[0] > 4."""
    v = (jnp.sum((x - 2.2) ** 2) * 0.05
         + jnp.sum(1.0 - jnp.cos(2.5 * (x - 2.2))))
    return jnp.where(x[0] > 4.0, jnp.inf, v)


def _deceptive_t(X):
    v = (torch.sum((X - 2.2) ** 2, dim=1) * 0.05
         + torch.sum(1.0 - torch.cos(2.5 * (X - 2.2)), dim=1))
    return torch.where(X[:, 0] > 4.0, torch.full_like(v, np.inf), v)


BOX = (np.array([-5.0, -5.0, -np.inf, 0.0]), np.array([5.0, 5.0, 3.0, np.inf]))
X0 = np.array([0.0, 1.0, -1.0, 2.0])


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def test_sample_box_replays_gp_tpu():
    key = jax.random.PRNGKey(3)
    lb, ub = BOX
    cj = jm.sample_box(key, jnp.asarray(lb), jnp.asarray(ub), 9, jnp.float64)
    ct = tm.sample_box(Replay(box_draws(key, 9, 4)), _t(lb), _t(ub), 9)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-15)
    # infinite bounds sample an 80-wide window
    assert ct[:, 2].min() >= 3.0 - 80.0 and ct[:, 3].max() <= 80.0


@pytest.mark.parametrize("search", ["random", "mvmo"])
@pytest.mark.parametrize("seed", [0, 1])
def test_search_matches_gp_tpu(search, seed):
    key = jax.random.PRNGKey(seed)
    lb, ub = BOX
    num, chunk = 150, 8
    args = (jnp.asarray(lb), jnp.asarray(ub), jnp.asarray(X0))
    if search == "random":
        xj, fj = jm.random_search(_deceptive_j, key, *args, num=num,
                                  chunk=chunk)
        draws = box_draws(key, num, 4)
        fn = tm.random_search
    else:
        xj, fj = jm.mvmo_search(_deceptive_j, key, *args, num=num,
                                chunk=chunk)
        draws = mvmo_draws(key, num, chunk, 4)
        fn = tm.mvmo_search
    replay = Replay(draws)
    xt, ft = fn(_deceptive_t, replay, _t(lb), _t(ub), _t(X0), num=num,
                chunk=chunk)
    assert not replay.queue                     # every draw was used
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-10)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10)


@pytest.mark.parametrize("search", ["random", "mvmo"])
def test_all_inf_falls_back_to_default(search):
    key = jax.random.PRNGKey(0)
    lb, ub = BOX
    num, chunk = 40, 8
    inf_j = lambda x: jnp.asarray(jnp.inf)
    inf_t = lambda X: torch.full((X.shape[0],), np.inf, dtype=X.dtype)
    jfn = jm.random_search if search == "random" else jm.mvmo_search
    xj, fj = jfn(inf_j, key, jnp.asarray(lb), jnp.asarray(ub),
                 jnp.asarray(X0), num=num, chunk=chunk)
    draws = (box_draws(key, num, 4) if search == "random"
             else mvmo_draws(key, num, chunk, 4))
    tfn = tm.random_search if search == "random" else tm.mvmo_search
    xt, ft = tfn(inf_t, Replay(draws), _t(lb), _t(ub), _t(X0), num=num,
                 chunk=chunk)
    assert float(ft) == float(fj) == np.inf
    np.testing.assert_array_equal(xt.numpy(), X0)
    np.testing.assert_array_equal(np.asarray(xj), X0)


def _bumpy_j(x):
    c = jnp.arange(x.shape[0], dtype=x.dtype) * 0.3 - 0.4
    return 0.2 * jnp.sum((x - c) ** 2) + jnp.sum(jnp.cos(4.0 * x))


def _bumpy_t(x):
    c = torch.arange(x.shape[0], dtype=x.dtype) * 0.3 - 0.4
    return 0.2 * torch.sum((x - c) ** 2) + torch.sum(torch.cos(4.0 * x))


def test_multistart_lbfgsb_matches_gp_tpu():
    """Each start's end value (rtol 1e-9) and the best start; the bumpy
    objective puts the starts in different local minima."""
    key = jax.random.PRNGKey(5)
    lb, ub = np.full(3, -2.0), np.full(3, 2.0)
    x0 = np.array([1.5, -1.5, 0.5])
    fj = jax.value_and_grad(_bumpy_j)
    rj = jm.multistart_lbfgsb(fj, key, jnp.asarray(lb), jnp.asarray(ub),
                              jnp.asarray(x0), n_starts=5, max_evals=80)

    def ft(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = _bumpy_t(x)
            g, = torch.autograd.grad(f, x)
        return f.detach(), g

    replay = Replay(box_draws(key, 4, 3))
    rt = tm.multistart_lbfgsb(ft, replay, _t(lb), _t(ub), _t(x0), n_starts=5,
                              max_evals=80)
    assert not replay.queue
    all_j = np.asarray(rj.all_f)
    np.testing.assert_allclose(rt.all_f.numpy(), all_j, rtol=1e-9)
    assert len(set(np.round(all_j, 6))) > 1      # more than one minimum
    assert int(np.argmin(all_j)) == int(torch.argmin(rt.all_f))
    np.testing.assert_allclose(float(rt.f), float(rj.f), rtol=1e-9)
    np.testing.assert_allclose(rt.all_x[0].numpy(), np.asarray(rj.all_x[0]),
                               rtol=1e-6, atol=1e-8)
    assert len(rt.evals) == 5 and all(1 <= e <= 80 + 25 for e in rt.evals)


def _problem(n=60, d=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, d))
    y = np.sin(X[:, 0]) + 0.1 * rng.standard_normal(n)
    return X, y


def test_batch_objective_equals_one_candidate():
    """The model's chunk objective gives each candidate's one-candidate
    value, INF for a non-SPD point and for sn2 > mean(sf2)."""
    X, y = _problem(n=50, d=3, seed=2)
    gt = TGP(X, y, device="cpu")
    rng = np.random.default_rng(4)
    h0 = gt._hyp_to_std(gt.get_default_hyps())
    vecs = h0 + rng.uniform(-1, 1, (6, h0.size))
    vecs[2, -2] += 8.0                       # sn2 > mean(sf2): rejected
    vecs[4, :3] += 6.0                       # huge length scales ...
    vecs[4, -2] = -40.0                      # ... no noise: not SPD
    V = _t(vecs)
    batch = gt._multistart_objective()(V)
    one = torch.stack([te.multistart_objective(gt.kernel, False, v, gt._x,
                                               gt._ys) for v in V])
    assert torch.equal(batch, one)
    assert batch[2] == np.inf and batch[4] == np.inf
    assert torch.isfinite(batch[[0, 1, 3, 5]]).all()


def test_select_init_hyp_matches_gp_tpu():
    X, y = _problem()
    gj = gp_tpu.GP(X, y)
    gt = TGP(X, y, device="cpu")
    num = 100
    chunk = gj._multistart_chunk()
    assert chunk == gt._multistart_chunk() == 32
    # gp_tpu's _next_key: the model's key PRNGKey(seed = 0), split once
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    gt.draws = Replay(mvmo_draws(sub, num, chunk, gt.num_hyp))
    start = gj.get_default_hyps()
    start[:2] += 1.5
    hj = gj.select_init_hyp(num, start)
    ht = gt.select_init_hyp(num, start)
    assert not gt.draws.queue
    np.testing.assert_allclose(ht, hj, rtol=1e-9)
    assert gt.last_search[1] == tm.mvmo_evaluations(num, chunk) == 25 + 96
    assert np.isfinite(gt.last_search[0])


def test_train_from_inf_start_enters_the_search():
    """Length scales at exp(-800): 1/l overflows, K is NaN, every start
    probe and the noise rescue are INF; train() enters the MVMO search
    (it raised before the search was ported) and ends at a finite NLL."""
    X, y = _problem()
    gt = TGP(X, y, device="cpu")
    bad = gt.get_default_hyps()
    bad[:2] = -800.0
    assert gt.nll(bad) == np.inf
    nll = gt.train(bad)
    assert np.isfinite(nll)
    assert gt.last_search is not None and np.isfinite(gt.last_search[0])
    assert gt.last_search[1] == tm.mvmo_evaluations(gt.num_hyp * 50, 32)
    mu = gt.batch_predict_y(X[:5])
    assert torch.isfinite(mu).all()


def test_train_multistart_matches_gp_tpu():
    """train_multistart from the default start with gp_tpu's start set:
    every start's end value at rtol 1e-6 (four 160-evaluation fits of a
    flat NLL: rounding moves where each stops, tests/test_torch_exact.py),
    the best start and the final NLL."""
    X, y = _problem(n=40, d=2, seed=1)
    gj = gp_tpu.GP(X, y, kernel="se_iso")
    gt = TGP(X, y, kernel="se_iso", device="cpu")
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    gt.draws = Replay(box_draws(sub, 3, gt.num_hyp))
    from gp_tpu.optim import multistart as jms
    seen = {}
    orig = jms.multistart_lbfgsb

    def spy(*a, **kw):
        seen["res"] = orig(*a, **kw)
        return seen["res"]
    jms.multistart_lbfgsb = spy
    try:
        nj = gj.train_multistart(n_starts=4)
    finally:
        jms.multistart_lbfgsb = orig
    nt = gt.train_multistart(n_starts=4)
    assert not gt.draws.queue
    all_j = np.asarray(seen["res"].all_f)
    all_t = gt.last_multistart.all_f.numpy()
    np.testing.assert_allclose(all_t, all_j, rtol=1e-6)
    assert int(np.argmin(all_j)) == int(np.argmin(all_t))
    np.testing.assert_allclose(nt, nj, rtol=1e-6)
