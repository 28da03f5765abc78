"""gp_tpu_torch's block Cholesky base cases (ops/chol_block.py) against
gp_tpu's Pallas kernels (ops/pallas_chol.py) in interpret mode, on the CPU
in float64, at gp_tpu's own test shapes (tests/test_pallas_chol.py).

On the CPU the wrappers run their plain versions, gp_tpu's loops in torch
ops; they do the same operations on every entry that lives on, so they
agree with the interpret-mode kernels to a few ulps (rtol 1e-12).  The
backwards are gp_tpu's pullbacks and are held to jax.vjp of its kernels
(rtol 1e-10).  The kernels themselves are held to these plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_tpu.ops.pallas_chol import (pallas_chol_inv, pallas_cholesky,
                                    pallas_cholesky_panel)
from gp_tpu_torch.ops import chol_block as cb
from gp_tpu_torch.ops.chol import chol_ok

RTOL = 1e-12


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * np.max(np.abs(b)))


@pytest.mark.parametrize("n", [8, 32, 128])
def test_chol_inv_matches_pallas(n):
    K = _spd(n, n + 1)
    Lj, Tj = pallas_chol_inv(jnp.asarray(K))
    cb.reset_launches()
    L, T = cb.chol_inv(torch.tensor(K))
    _close(L.numpy(), Lj)
    _close(T.numpy(), Tj)
    # lower triangular outputs, and no kernel launch for a CPU tensor
    assert not np.any(np.triu(L.numpy(), 1)) \
        and not np.any(np.triu(T.numpy(), 1))
    assert not any(cb.launches.values())


@pytest.mark.parametrize("n", [8, 32, 128])
def test_cholesky_block_matches_pallas(n):
    K = _spd(n, n)
    _close(cb.cholesky_block(torch.tensor(K)).numpy(),
           pallas_cholesky(jnp.asarray(K)))


@pytest.mark.parametrize("n,w", [(64, 8), (128, 32)])
def test_cholesky_panel_matches_pallas(n, w):
    K = _spd(n, n + w)
    _close(cb.cholesky_panel(torch.tensor(K), w).numpy(),
           pallas_cholesky_panel(jnp.asarray(K), w))


def test_cholesky_panel_rejects_a_width_that_does_not_divide():
    with pytest.raises(ValueError, match="must divide"):
        cb.cholesky_panel(torch.tensor(_spd(48, 1)), 32)
    with pytest.raises(ValueError, match="square"):
        cb.chol_inv(torch.zeros(4, 5, dtype=torch.float64))


@pytest.mark.parametrize("which", ["chol_inv", "block", "panel"])
def test_nan_on_indefinite(which):
    K = _spd(32, 3)
    K[12, 12] = -1e3              # the leading minor of order 13 fails
    Kt = torch.tensor(K)
    if which == "chol_inv":
        L, T = cb.chol_inv(Kt)
        Lj, _ = pallas_chol_inv(jnp.asarray(K))
        assert np.all(np.isnan(T.numpy()[12:, :13]))
    elif which == "block":
        L, Lj = cb.cholesky_block(Kt), pallas_cholesky(jnp.asarray(K))
    else:
        L = cb.cholesky_panel(Kt, 8)
        Lj = pallas_cholesky_panel(jnp.asarray(K), 8)
    assert not bool(chol_ok(L))
    # NaN from the failing pivot on, in every later column (gp_tpu's
    # contract); the factor before it is the leading block's
    L = L.numpy()
    assert np.all(np.isnan(L[12:, 12:][np.tri(20) > 0]))
    assert np.all(np.isfinite(L[:12]))
    _close(L[:12, :12], np.asarray(Lj)[:12, :12])
    _close(L[:12, :12], np.linalg.cholesky(K[:12, :12]))


def test_chol_inv_backward_matches_jax_vjp():
    n = 24
    K = _spd(n, 9)
    rng = np.random.default_rng(11)
    Lbar = np.tril(rng.standard_normal((n, n)))
    Tbar = np.tril(rng.standard_normal((n, n)))
    _, vjp = jax.vjp(pallas_chol_inv, jnp.asarray(K))
    Kt = torch.tensor(K, requires_grad=True)
    L, T = cb.chol_inv(Kt)
    g, = torch.autograd.grad((L, T), Kt, (torch.tensor(Lbar),
                                          torch.tensor(Tbar)))
    _close(g.numpy(), vjp((jnp.asarray(Lbar), jnp.asarray(Tbar)))[0],
           rtol=1e-10)
    # only L reaches the loss: T's cotangent is None
    Kt = torch.tensor(K, requires_grad=True)
    g, = torch.autograd.grad(cb.chol_inv(Kt)[0], Kt, torch.tensor(Lbar))
    _close(g.numpy(), vjp((jnp.asarray(Lbar), jnp.zeros((n, n))))[0],
           rtol=1e-10)


@pytest.mark.parametrize("which", ["block", "panel"])
def test_cholesky_backward_matches_jax_vjp(which):
    n = 24
    K = _spd(n, 5)
    Lbar = np.tril(np.random.default_rng(6).standard_normal((n, n)))
    if which == "block":
        fj, ft = pallas_cholesky, cb.cholesky_block
    else:
        fj = lambda A: pallas_cholesky_panel(A, 8)
        ft = lambda A: cb.cholesky_panel(A, 8)
    _, vjp = jax.vjp(fj, jnp.asarray(K))
    Kt = torch.tensor(K, requires_grad=True)
    g, = torch.autograd.grad(ft(Kt), Kt, torch.tensor(Lbar))
    _close(g.numpy(), vjp(jnp.asarray(Lbar))[0], rtol=1e-10)
