"""Dense-solver strategies for the exact GP (counterpart of
gp_tpu/ops/solvers.py): the reference's MatrixSolver layer
(MatrixSolver.{h,cpp}) as a decomp / check / log_det / solve bundle.

  CHOL      LLT Cholesky (MatrixSolverLLT, MatrixSolver.cpp:6-28); a
            failure shows as NaN in the factor and the models' noise-
            inflation loop recovers (GP.cpp:431-440).
  QR        Householder QR, torch.linalg.qr as gp_tpu's jnp.linalg.qr
            (unpivoted); rank problems are caught by the relative
            diagonal test of _qr_ok.  log|det| is the absolute value, and
            an indefinite but invertible K succeeds, as in the
            reference's QR path.
  QR_PIVOT  column-pivoted Householder QR, the reference's default
            (ColPivHouseholderQR, MatrixSolver.cpp:31-53): ops/qr_pivot.py,
            gp_tpu's loop.

The sparse models keep their Cholesky with jitter doubling and accept a
solver name without using it, as gp_tpu's do.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .chol import chol_logdet, chol_ok, chol_solve, cholesky
from .qr_pivot import qr_pivot, qrp_logabsdet, qrp_ok, qrp_solve


class SolverSpec(NamedTuple):
    """decomp / check_SPD / log_det / solve strategy (MatrixSolver.h:3-13)."""
    name: str
    factor: Callable        # K -> factors (tuple of tensors)
    ok: Callable            # factors -> () bool tensor
    logdet: Callable        # factors -> () log|K|
    solve: Callable         # factors, b -> K^{-1} b


CHOL = SolverSpec(
    name="chol",
    factor=lambda K: (cholesky(K),),
    ok=lambda f: chol_ok(f[0]),
    logdet=lambda f: chol_logdet(f[0]),
    solve=lambda f, b: chol_solve(f[0], b),
)


def _qr_factor(K):
    Q, R = torch.linalg.qr(K)
    return Q, R


def _qr_solve(f, b):
    Q, R = f
    vec = b.ndim == 1
    z = torch.linalg.solve_triangular(R, Q.T @ (b[:, None] if vec else b),
                                      upper=True)
    return z[:, 0] if vec else z


QR = SolverSpec(
    name="qr",
    factor=_qr_factor,
    # Eigen's isInvertible (MatrixSolver.cpp:42-45): every |R_ii| above a
    # relative threshold; the same test as the pivoted form's
    ok=lambda f: qrp_ok(f[1]),
    # logAbsDeterminant (MatrixSolver.cpp:46-49)
    logdet=lambda f: qrp_logabsdet(f[1]),
    solve=_qr_solve,
)

QR_PIVOT = SolverSpec(
    name="qr_pivot",
    factor=qr_pivot,
    ok=lambda f: qrp_ok(f[1]),
    logdet=lambda f: qrp_logabsdet(f[1]),
    solve=lambda f, b: qrp_solve(f[0], f[1], f[2], b),
)


SOLVERS = {"chol": CHOL, "cholesky": CHOL, "qr": QR, "qr_pivot": QR_PIVOT,
           "qrp": QR_PIVOT}


def get_solver(name_or_spec) -> SolverSpec:
    """Factory mirroring GP::_specify_matrix_solver (GP.cpp:588-600)."""
    if isinstance(name_or_spec, SolverSpec):
        return name_or_spec
    try:
        return SOLVERS[str(name_or_spec).lower()]
    except KeyError:
        raise ValueError(
            f"Unknown solver {name_or_spec!r}; available: chol, qr, "
            f"qr_pivot") from None
