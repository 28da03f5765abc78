"""Dense-solver strategy for the exact GP (counterpart of
gp_tpu/ops/solvers.py): the reference's MatrixSolver layer
(MatrixSolver.{h,cpp}) as a decomp / check / log_det / solve bundle.

Only CHOL is ported.  The QR strategies ("qr", "qr_pivot") are ROADMAP
module 12 and raise NotImplementedError until then.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from .chol import chol_logdet, chol_ok, chol_solve, cholesky


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

SOLVERS = {"chol": CHOL, "cholesky": CHOL}
_NOT_PORTED = ("qr", "qr_pivot", "qrp")


def get_solver(name_or_spec) -> SolverSpec:
    """Factory mirroring GP::_specify_matrix_solver (GP.cpp:588-600)."""
    if isinstance(name_or_spec, SolverSpec):
        return name_or_spec
    name = str(name_or_spec).lower()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"solver {name!r} is not ported yet (ROADMAP module 12, QR "
            f"strategies); use 'chol'")
    try:
        return SOLVERS[name]
    except KeyError:
        raise ValueError(
            f"Unknown solver {name_or_spec!r}; available: chol") from None
