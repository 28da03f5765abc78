"""Cholesky solver core (counterpart of gp_tpu/ops/chol.py).

Failure contract, as gp_tpu's: a failed factorization returns a factor
with NaN from the first failing pivot on (the library route: in its whole
lower triangle); `chol_ok` reads the diagonal,
and the NLL and the noise-inflation loops turn that into INF or another
try.

Routing, as gp_tpu's "on the accelerator" (chol.py:25-31): a 2-D
factorization of N >= _BLOCKED_MIN_N on a CUDA device takes the blocked
route (ops/blocked.py), whose leaves are the hand-written K3 kernel;
there a failing leaf's NaN reaches every later panel.  The CPU and
smaller N take the library factor, `library_cholesky`:
`torch.linalg.cholesky` raises on failure, so the factor comes from
`cholesky_ex`, and `info > 0` turns the whole lower triangle to NaN, as
gp_tpu's `jnp.linalg.cholesky` returns it (chol.py:70): on the device,
with `torch.where`: no host sync.

The solves stay library calls on every route (gp_tpu's blocked solves
are not carried, see ops/blocked.py).
"""

from __future__ import annotations

import torch

from ..utils.profiling import span

# the size from which a CUDA factorization takes the blocked route.  gp_tpu
# uses 2048 on its TPU; on an H100 the library route's evaluation is the
# faster one up to 4096 rows (1.2-3.4x), the two tie at 6144 in float32
# and the blocked route wins from 6144 in float64 and at 8000 in both
# (chip_smoke.py's route_sweep, SE-ARD)
_BLOCKED_MIN_N = 6144


def _use_blocked(n: int, device) -> bool:
    return n >= _BLOCKED_MIN_N and torch.device(device).type == "cuda"


def _block_for(n: int) -> int:
    """gp_tpu's panel width for N (chol.py:34-43)."""
    if n <= 24576:
        return 1024
    if n <= 65536:
        return 2048
    return 4096


def library_cholesky(K):
    """Lower Cholesky factor by the library (cuSOLVER on the card, LAPACK
    on the CPU); a failed factorization is NaN in its whole lower
    triangle, zeros above."""
    L, info = torch.linalg.cholesky_ex(K)
    n = K.shape[-1]
    lower = torch.ones(n, n, dtype=torch.bool, device=K.device).tril()
    bad = (info > 0)[..., None, None] & lower
    return torch.where(bad, torch.full((), float("nan"), dtype=L.dtype,
                                       device=L.device), L)


def cholesky(K):
    """Lower Cholesky factor; NaN from the first failing pivot on."""
    n = K.shape[-1]
    if K.ndim == 2 and _use_blocked(n, K.device):
        from .blocked import blocked_cholesky
        return blocked_cholesky(K, block=_block_for(n))
    return library_cholesky(K)


def blocked_factor(K, base_fn=None):
    """The blocked route's factor of K (n x n): K padded once to the panel
    multiple (blockdiag(K, I)), then blocked_cholesky with the panels'
    diagonal-block inverses.  Returns (Lp, Td, block) at the padded size;
    Lp's strictly-upper triangle holds K leftovers.  base_fn as in
    blocked_cholesky (None: the K3 leaf)."""
    from .blocked import blocked_cholesky, eye_pad
    n = K.shape[-1]
    blk = _block_for(n)
    Kp = eye_pad(K, blk - n % blk) if n % blk else K
    Lp, Td = blocked_cholesky(Kp, block=blk, zero_upper=False,
                              base_fn=base_fn, return_diag_inv=True)
    return Lp, Td, blk


def factor_and_inverse(K, blocked=None):
    """(L, K^-1) of K (n x n), the objective's factor and explicit inverse.

    blocked=None takes the route `_use_blocked` picks for K; True or False
    forces one.  Blocked (gp_tpu's accelerator branch, exact.py:157-185):
    blocked_factor, then the lauum spd_inv_from_chol reusing its Td, both
    kept padded (the pad block of the factor and of the inverse is I) and
    sliced back to n.  L's strictly-upper triangle then holds K leftovers:
    read its lower triangle (chol_logdet reads the diagonal).  Library:
    `library_cholesky` and `torch.cholesky_inverse`."""
    from .blocked import spd_inv_from_chol, spd_inv_library
    n = K.shape[-1]
    if blocked is None:
        blocked = _use_blocked(n, K.device)
    if not blocked:
        with span("objective.factor"):
            L = library_cholesky(K)
        with span("objective.inverse"):
            return L, spd_inv_library(L)
    with span("objective.factor"):
        Lp, Td, blk = blocked_factor(K)
    with span("objective.inverse"):
        Kinv = spd_inv_from_chol(Lp, block=blk, diag_inv=Td)
    return Lp[:n, :n], Kinv[:n, :n]


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


def solve_lower_t(L, z):
    """Solve L^T x = z (back substitution on the lower factor)."""
    vec = z.ndim == 1
    x = torch.linalg.solve_triangular(L.mT, z[:, None] if vec else z,
                                      upper=True)
    return x[:, 0] if vec else x
