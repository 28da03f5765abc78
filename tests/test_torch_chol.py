"""gp_tpu_torch Cholesky helpers against gp_tpu.ops.chol, CPU float64.

Failure contract: gp_tpu's library factor of a non-SPD matrix
(`jnp.linalg.cholesky`) is NaN in its whole lower triangle, zeros above;
the port's library factor is the same.  `chol_ok` is False for both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_tpu.ops import chol as jc
from gp_tpu_torch.ops import blocked as tb
from gp_tpu_torch.ops import chol as tc
from gp_tpu_torch.ops import solvers as ts


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    return B @ B.T + n * np.eye(n)


@pytest.mark.parametrize("n", [50, 37])
def test_spd_factor_logdet_solve_match(n):
    A = _spd(n, n)
    rng = np.random.default_rng(1)
    b = rng.standard_normal(n)
    B = rng.standard_normal((n, 3))
    Lj = jc.cholesky(jnp.asarray(A))
    Lt = tc.cholesky(torch.tensor(A))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=1e-12,
                               atol=1e-14)
    assert bool(tc.chol_ok(Lt)) and bool(jc.chol_ok(Lj))
    np.testing.assert_allclose(float(tc.chol_logdet(Lt)),
                               float(jc.chol_logdet(Lj)), rtol=1e-13)
    for rhs in (b, B):
        np.testing.assert_allclose(
            tc.chol_solve(Lt, torch.tensor(rhs)).numpy(),
            np.asarray(jc.chol_solve(Lj, jnp.asarray(rhs))), rtol=1e-10)
        np.testing.assert_allclose(
            tc.solve_lower(Lt, torch.tensor(rhs)).numpy(),
            np.asarray(jc.solve_lower(Lj, jnp.asarray(rhs))), rtol=1e-10)


@pytest.mark.parametrize("bad", [0, 2, 6])
def test_indefinite_gives_nan_rows_from_failing_pivot(bad):
    n = 8
    A = _spd(n, 3)
    # make the leading minor of order bad+1 indefinite
    A[bad, bad] = -1e3
    Lj = jc.cholesky(jnp.asarray(A))
    Lt = tc.cholesky(torch.tensor(A)).numpy()
    assert not bool(jc.chol_ok(Lj))
    assert not bool(tc.chol_ok(torch.tensor(Lt)))
    Lj = np.asarray(Lj)
    np.testing.assert_array_equal(np.isnan(Lt), np.isnan(Lj))
    assert np.all(np.isnan(Lt[np.tril_indices(n)]))
    np.testing.assert_array_equal(Lt[~np.isnan(Lt)], Lj[~np.isnan(Lj)])
    assert np.isnan(float(tc.chol_logdet(torch.tensor(Lt))))


def test_chol_solver_spec_and_helpers():
    A = _spd(20, 5)
    f = ts.CHOL.factor(torch.tensor(A))
    assert bool(ts.CHOL.ok(f))
    np.testing.assert_allclose(float(ts.CHOL.logdet(f)),
                               np.linalg.slogdet(A)[1], rtol=1e-12)
    np.testing.assert_allclose(tb.spd_inv_from_chol(f[0]).numpy(),
                               np.linalg.inv(A), rtol=1e-10, atol=1e-14)
    K = torch.tensor(A)
    d0 = K.diagonal().clone()
    assert tb.add_diag(K, 0.5) is K
    np.testing.assert_array_equal(K.diagonal().numpy(), (d0 + 0.5).numpy())
    assert ts.get_solver("chol") is ts.CHOL
    for name in ("qr", "qr_pivot"):
        with pytest.raises(NotImplementedError, match="module 12"):
            ts.get_solver(name)
