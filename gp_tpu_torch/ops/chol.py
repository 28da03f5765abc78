"""Cholesky solver core (counterpart of gp_tpu/ops/chol.py).

Failure contract, as gp_tpu's: a failed factorization returns a factor
whose rows from the first failing pivot on are NaN; `chol_ok` reads the
diagonal, and the NLL and the noise-inflation loops turn that into INF
or another try.  `torch.linalg.cholesky` raises instead, so the factor
comes from `cholesky_ex`, and `info > 0` (the order of the first leading
minor that is not positive definite) is mapped onto NaN rows info-1: on
the device, with `torch.where` against an `arange`: no host sync.

The factorization itself is a library call (cuSOLVER on the card), as it
is XLA's on gp_tpu's non-TPU path; the blocked MXU routines gp_tpu uses
on the TPU are not carried (see ops/blocked.py).
"""

from __future__ import annotations

import torch


def cholesky(K):
    """Lower Cholesky factor; rows from the first failing pivot are NaN."""
    L, info = torch.linalg.cholesky_ex(K)
    rows = torch.arange(K.shape[-1], device=K.device)
    bad = (info[..., None] > 0) & (rows >= info[..., None] - 1)
    return torch.where(bad[..., :, None],
                       torch.full((), float("nan"), dtype=L.dtype,
                                  device=L.device), L)


def chol_ok(L):
    """SPD test: the factor diagonal is finite and strictly positive."""
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return torch.all(torch.isfinite(d) & (d > 0), dim=-1)


def chol_logdet(L):
    """log|K| = 2 sum log diag(L)  (MatrixSolver.cpp:21-24)."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                           dim=-1)


def chol_solve(L, b):
    """Solve K x = b given K = L L^T (b: (n,) or (n, k))."""
    vec = b.ndim == 1
    x = torch.cholesky_solve(b[:, None] if vec else b, L)
    return x[:, 0] if vec else x


def solve_lower(L, b):
    """Solve L z = b (forward substitution)."""
    vec = b.ndim == 1
    z = torch.linalg.solve_triangular(L, b[:, None] if vec else b,
                                      upper=False)
    return z[:, 0] if vec else z
