"""gp_tpu_torch's blocked factorization and inverse (ops/blocked.py) and the
objective's blocked branch against gp_tpu's, on the CPU in float64.

gp_tpu takes its K3 leaf (pallas_chol_inv, interpret mode here) only when
`_pallas_leaf_enabled` says so; the tests patch it on, so both packages
run the same algorithm with the same leaf.  The port's routing
(`chol._use_blocked`, `_block_for`) is patched, or the route named, so
that small problems take the branch that the card takes from
chol._BLOCKED_MIN_N rows.  Blocked routines: rtol 1e-11 of the largest
entry.  Objective: NLL rtol 1e-10, gradient rtol
1e-7 (the bounds tests/test_golden.py holds gp_tpu to).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_tpu
import gp_tpu.ops.blocked as jb
import gp_tpu.ops.chol as jc
from gp_tpu.models import exact as je
from gp_tpu_torch import GP as TGP
from gp_tpu_torch.models import exact as te
from gp_tpu_torch.ops import blocked as tb
from gp_tpu_torch.ops import chol as tc
from gp_tpu_torch.ops import chol_block as cb
from gp_tpu_torch.utils.convert import gp_from_state

RTOL = 1e-11


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * np.max(np.abs(b)))


@pytest.fixture
def jax_k3_leaf(monkeypatch):
    monkeypatch.setattr(jb, "_pallas_leaf_enabled", lambda dtype: True)


@pytest.fixture
def leaf_count(monkeypatch):
    """Counts the K3 leaves the port runs (its plain version, here)."""
    calls = []
    plain = cb.chol_inv_plain

    def counted(K):
        calls.append(K.shape[0])
        return plain(K)
    monkeypatch.setattr(cb, "chol_inv_plain", counted)
    return calls


@pytest.mark.parametrize("n,block,base,zero_upper", [
    (128, 64, 16, True),       # aligned, two recursion levels
    (100, 64, 16, True),       # padded to blockdiag(K, I)
    (128, 64, 16, False),      # K leftovers above the diagonal blocks
    (100, 128, 64, True),      # pad to one panel
    (48, 64, 64, True),        # n <= base: the library factor
])
def test_blocked_cholesky_matches_gp_tpu(jax_k3_leaf, leaf_count, n, block,
                                         base, zero_upper):
    K = _spd(n, n)
    Lj = jb.blocked_cholesky(jnp.asarray(K), block=block, base_block=base,
                             zero_upper=zero_upper)
    Kt = torch.tensor(K)
    L = tb.blocked_cholesky(Kt, block=block, base_block=base,
                            zero_upper=zero_upper)
    _close(L.numpy(), Lj)
    assert torch.equal(Kt, torch.tensor(K))          # K is not modified
    assert bool(leaf_count) == (n > base)
    assert all(m <= base for m in leaf_count)


def test_blocked_cholesky_return_diag_inv(jax_k3_leaf):
    K = _spd(128, 8)
    Lj, Tdj = jb.blocked_cholesky(jnp.asarray(K), block=32, base_block=16,
                                  zero_upper=False, return_diag_inv=True)
    L, Td = tb.blocked_cholesky(torch.tensor(K), block=32, base_block=16,
                                zero_upper=False, return_diag_inv=True)
    assert tuple(Td.shape) == (4, 32, 32)
    _close(L.numpy(), Lj)
    _close(Td.numpy(), Tdj)
    # library fallback (block % base != 0): no panel structure
    assert tb.blocked_cholesky(torch.tensor(K), block=32, base_block=24,
                               return_diag_inv=True)[1] is None


@pytest.mark.parametrize("base_fn", ["block", "panel"])
def test_blocked_cholesky_with_base_fn(base_fn):
    K = _spd(256, 4)
    fn = cb.cholesky_block if base_fn == "block" \
        else lambda A: cb.cholesky_panel(A, 16)
    L = tb.blocked_cholesky(torch.tensor(K), block=128, base_block=32,
                            base_fn=fn)
    _close(L.numpy(), np.linalg.cholesky(K), rtol=1e-10)


def test_blocked_cholesky_nan_on_indefinite():
    K = _spd(256, 1) - 600.0 * np.eye(256)
    L = tb.blocked_cholesky(torch.tensor(K), block=128, base_block=64)
    assert not bool(tc.chol_ok(L))
    assert bool(torch.isnan(L[-1, -1]))     # reaches the last panel


@pytest.mark.parametrize("m,block,base", [(100, 64, 32), (128, 64, 16)])
def test_chol_inv_block_matches_gp_tpu(jax_k3_leaf, m, block, base):
    """100: the split (32) does not divide m, the unfused fallback."""
    K = _spd(m, 3)
    Lj, Tj = jb._chol_inv_block(jnp.asarray(K), block, base, None)
    L, T = tb._chol_inv_block(torch.tensor(K), block, base, None)
    _close(np.tril(L.numpy()), np.tril(np.asarray(Lj)))
    _close(T.numpy(), Tj)


@pytest.mark.parametrize("n,base", [(128, 32), (100, 32), (20, 32)])
def test_tri_inv_matches_gp_tpu(n, base):
    L = np.linalg.cholesky(_spd(n, 5))
    _close(tb.tri_inv(torch.tensor(L), base=base).numpy(),
           jb.tri_inv(jnp.asarray(L), base=base))


def test_tri_inv_from_diag_and_spd_inv_match_gp_tpu(jax_k3_leaf):
    K = _spd(128, 6)
    Lj, Tdj = jb.blocked_cholesky(jnp.asarray(K), block=32, base_block=16,
                                  zero_upper=False, return_diag_inv=True)
    L, Td = tb.blocked_cholesky(torch.tensor(K), block=32, base_block=16,
                                zero_upper=False, return_diag_inv=True)
    _close(tb.tri_inv_from_diag(L, Td, 32).numpy(),
           jb.tri_inv_from_diag(Lj, Tdj, 32))
    Ki = tb.spd_inv_from_chol(L, block=32, diag_inv=Td)
    _close(Ki.numpy(), jb.spd_inv_from_chol(Lj, block=32, diag_inv=Tdj))
    _close(Ki.numpy(), np.linalg.inv(K), rtol=1e-9)
    assert torch.equal(Ki, Ki.T)


@pytest.mark.parametrize("n,block", [(128, 32), (100, 32), (20, 32)])
def test_spd_inv_from_chol_matches_gp_tpu(n, block):
    L = np.linalg.cholesky(_spd(n, n + 1))
    Ki = tb.spd_inv_from_chol(torch.tensor(L), block=block, base=16)
    _close(Ki.numpy(), jb.spd_inv_from_chol(jnp.asarray(L), block=block,
                                            base=16))


def test_triangular_matmuls_match_gp_tpu():
    rng = np.random.default_rng(11)
    A = rng.standard_normal((24, 160))
    T = np.tril(rng.standard_normal((160, 160)))
    for cutoff in (32, 50, 160):
        _close(tb.lt_matmul(torch.tensor(A), torch.tensor(T), cutoff)
               .numpy(), jb.lt_matmul(jnp.asarray(A), jnp.asarray(T),
                                      cutoff))
        _close(tb.ut_matmul(torch.tensor(A), torch.tensor(T.T), cutoff)
               .numpy(), jb.ut_matmul(jnp.asarray(A), jnp.asarray(T.T),
                                      cutoff))


def _problem(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, d))
    y = (np.sin(2 * X[:, 0]) + 0.5 * np.cos(3 * X[:, -1])
         + 0.1 * rng.standard_normal(n))
    return X, y


@pytest.fixture
def blocked_routes(monkeypatch, jax_k3_leaf):
    """Both packages' objectives take the blocked branch with 128-wide
    panels (K3 leaves of 128).  gp_tpu's far-pad decoy branch, which the
    port does not carry, is switched off per kernel below: gp_tpu then
    pads once, as the port does."""
    monkeypatch.setattr(tc, "_use_blocked", lambda n, device: True)
    monkeypatch.setattr(tc, "_block_for", lambda n: 128)
    monkeypatch.setattr(jc, "_use_blocked", lambda n: True)
    monkeypatch.setattr(jc, "_block_for", lambda n: 128)


@pytest.mark.parametrize("n,block,leaves", [(200, 128, [128, 128]),
                                            (256, 128, [128, 128])])
def test_factor_and_inverse_routes(monkeypatch, leaf_count, n, block,
                                   leaves):
    """The blocked route (padded once, or aligned) and the library route
    give the same factor and inverse; the route follows _use_blocked
    unless the caller names one."""
    monkeypatch.setattr(tc, "_block_for", lambda n: block)
    K = torch.tensor(_spd(n, 9))
    Lb, Kib = tc.factor_and_inverse(K, blocked=True)
    assert leaf_count == leaves
    assert tuple(Lb.shape) == tuple(Kib.shape) == (n, n)
    Ll, Kil = tc.factor_and_inverse(K)          # on the CPU: the library
    assert leaf_count == leaves
    _close(torch.tril(Lb).numpy(), Ll.numpy())
    _close(Kib.numpy(), Kil.numpy(), rtol=1e-10)
    _close(Kil.numpy(), np.linalg.inv(_spd(n, 9)), rtol=1e-10)
    monkeypatch.setattr(tc, "_use_blocked", lambda n, device: True)
    tc.factor_and_inverse(K)
    assert leaf_count == 2 * leaves


@pytest.mark.parametrize("kernel", ["se_ard", "matern52"])
def test_nll_vg_blocked_matches_gp_tpu(blocked_routes, leaf_count, kernel):
    X, y = _problem(200, 3, 2)
    gj = gp_tpu.GP(X, y, kernel=kernel)
    gt = TGP(X, y, kernel=kernel, device="cpu")
    hyp = np.asarray(gj.get_default_hyps(), np.float64)
    hyp += np.random.default_rng(0).uniform(-0.3, 0.3, hyp.shape)
    kj = gj.kernel._replace(far_pad_ok=False)
    fj, g_j = je.nll_vg_raw(kj, jnp.asarray(hyp), gj._x, gj._y)
    ht = torch.tensor(hyp)
    ft, g_t = te.nll_vg_raw(gt.kernel, ht, gt._x, gt._y)
    # 200 pads to 256: two panels of one 128 leaf each
    assert leaf_count == [128, 128]
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-10)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-7,
                               atol=1e-7 * np.max(np.abs(g_j)))
    # and the port's library branch on the same inputs
    fl, g_l = te.nll_vg_raw(gt.kernel, ht, gt._x, gt._y, blocked=False)
    np.testing.assert_allclose(float(ft), float(fl), rtol=1e-10)
    np.testing.assert_allclose(g_t.numpy(), g_l.numpy(), rtol=1e-7,
                               atol=1e-7 * float(g_l.abs().max()))


def test_train_through_blocked_branch_matches_library(monkeypatch,
                                                      leaf_count):
    """A short fit (40 evaluations): 150 rows pad to two 128 panels, two
    K3 leaves per factorization."""
    X, y = _problem(150, 1, 4)
    lib = TGP(X, y, device="cpu")
    lib._MAX_EVAL = 40
    nll_lib = lib.train()
    assert not leaf_count
    monkeypatch.setattr(tc, "_use_blocked", lambda n, device: True)
    monkeypatch.setattr(tc, "_block_for", lambda n: 128)
    blk = TGP(X, y, device="cpu")
    blk._MAX_EVAL = 40
    nll_blk = blk.train()
    # every evaluation and set_k factored through the K3 leaf
    assert len(leaf_count) > 2 * blk.last_opt_result.evals
    np.testing.assert_allclose(nll_blk, nll_lib, rtol=1e-8)
    np.testing.assert_allclose(blk.get_hyp(), lib.get_hyp(), atol=1e-5)
    # the posterior at the library fit's hyps, factored down the blocked
    # branch (set_k), predicts what the library's does
    post = gp_from_state({"x": X, "y": y, "hyps": lib.get_hyp(),
                          "dtype": "float64"}, device="cpu")
    Xs = np.random.default_rng(5).uniform(-2, 2, (30, 1))
    for a, b in zip(post.batch_predict(Xs), lib.batch_predict(Xs)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9,
                                   atol=1e-12)
