"""VFE sparse GP (Titsias variational free energy; counterpart of
gp_tpu/models/vfe.py; reference: VFE.{h,cpp}).

The structure of FITC (models/fitc.py) with the variational objective:

  A     = sn2 Kuu + Kux Kxu                                 (VFE.cpp:174)
  NLL   = 0.5 [ N log 2pi + log|A| - log|Kuu| + (N-M) log sn2 + y^T alpha ]
        + 0.5 (sum diag K - tr(Kuu^-1 Kux Kxu)) / sn2       (VFE.cpp:185-189)
  alpha = (y - Kxu A^-1 Kux y) / sn2                        (VFE.cpp:183)

The trailing trace term is the FITC/VFE difference.  The hyp gradient
(VFE.cpp:197-241) is torch autograd of this objective (models/sparse.py).

The reference's quirks, kept as gp_tpu keeps them:
  * VFE::_predict is a stub (VFE.cpp:109-112); here batch_predict gives the
    mean and the VFE variance, a superset.
  * The variance adds no sn2 and floors at 0 (VFE.cpp:125-131).
  * VFE::_setK adds the jitter to Kuu cumulatively while doubling it
    (VFE.cpp:146-158), and the model keeps its jitter as it was.
  * A failed fit re-seeds through the global search and retries once
    (VFE.cpp:94-101).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.chol import chol_logdet, chol_ok, chol_solve, library_cholesky
from ..ops.chol import solve_lower
from .base import (debug_decomp_enabled, debug_print_nll_decomp, hyp_mean,
                   hyp_sn2)
from .sparse import (SparseFns, SparseGPBase, eye_like, inf_nll, local_fit,
                     search_value, straight_through, value_and_grad,
                     zero_like)
from .sparse import predict_y, predict_y_with_grad  # noqa: F401 (gp_tpu API)


# --------------------------------------------------------------------------
# Pure functions
# --------------------------------------------------------------------------

def nll_raw(kernel, hyp, x, y, u, jitter):
    """VFE::_calcNegLogProb (VFE.cpp:161-189); NaN/inf propagate.
    Under debug_decomp_enabled() prints gp_tpu's "vfe_nll" breakdown."""
    n, d = x.shape
    m = u.shape[0]
    nc = kernel.num_hyp(d)
    chyp = hyp[:nc]
    sn2 = hyp_sn2(hyp)
    r = y - hyp_mean(hyp)

    Kuu = kernel.k(chyp, u, u) + jitter * eye_like(m, x)
    Kxu = kernel.k(chyp, x, u)
    Kuxxu = Kxu.T @ Kxu
    A = sn2 * Kuu + Kuxxu

    Luu = library_cholesky(Kuu)
    LA = library_cholesky(A)

    alpha = (r - Kxu @ chol_solve(LA, Kxu.T @ r)) / sn2
    f0 = 0.5 * n * math.log(2 * math.pi)
    complexity = 0.5 * (chol_logdet(LA) - chol_logdet(Luu)
                        + (n - m) * torch.log(sn2))
    data_fit = 0.5 * torch.dot(r, alpha)
    V = solve_lower(Luu, Kxu.T)          # tr(Kuu^-1 Kuxxu) = |V|_F^2
    # the trace of the Nystrom residual is >= 0 mathematically
    resid = torch.sum(kernel.diag_k(chyp, x)) - torch.sum(V * V)
    trace_term = 0.5 * torch.maximum(resid, zero_like(resid)) / sn2
    nlz = f0 + complexity + data_fit + trace_term
    if debug_decomp_enabled():
        # gp_tpu's per-evaluation breakdown (vfe.py:70-75)
        debug_print_nll_decomp("vfe_nll", nlz=nlz, data_fit=data_fit,
                               complexity=complexity, trace_term=trace_term,
                               norm_const=f0)
    return nlz


def nll(kernel, hyp, x, y, u, jitter):
    return inf_nll(nll_raw(kernel, hyp, x, y, u, jitter))


def objective_vg(kernel, noise_free: bool, vec, x, y, u, jitter):
    return value_and_grad(nll_raw, kernel, noise_free, vec, x, y, u, jitter)


def multistart_objective(kernel, noise_free: bool, vec, x, y, u, jitter):
    return search_value(nll_raw, kernel, noise_free, vec, x, y, u, jitter)


def fit(kernel, noise_free: bool, x, y, u, jitter, vec0, lb, ub,
        max_evals: int = 150):
    return local_fit(nll_raw, kernel, noise_free, x, y, u, jitter, vec0, lb,
                     ub, max_evals)


@torch.no_grad()
def set_k(kernel, hyp, x, y, u, jitter0, max_tries: int = 64):
    """VFE::_setK (VFE.cpp:132-160): A = Kuu + Kux Kxu / sn2 (the NLL's A
    over sn2); on failure the jitter is ADDED to Kuu cumulatively, then
    doubled.  alpha = A^-1 Kux r / sn2.

    Returns (Luu, LA, alpha, total_added, ok)."""
    m = u.shape[0]
    nc = kernel.num_hyp(x.shape[1])
    chyp = hyp[:nc]
    sn2 = hyp_sn2(hyp)
    r = y - hyp_mean(hyp)
    Kuu0 = kernel.k(chyp, u, u)
    Kxu = kernel.k(chyp, x, u)
    Kuxxu = Kxu.T @ Kxu
    eye = eye_like(m, x)

    def attempt(added):
        Kuu = Kuu0 + added * eye
        return library_cholesky(Kuu), library_cholesky(Kuu + Kuxxu / sn2)

    added = torch.zeros((), dtype=x.dtype, device=x.device)
    jitter = torch.as_tensor(jitter0, dtype=x.dtype, device=x.device)
    Luu, LA = attempt(added)
    tries = 0
    while not bool(chol_ok(Luu) & chol_ok(LA)) and tries < max_tries:
        added = added + jitter
        Luu, LA = attempt(added)
        jitter = jitter * 2.0
        tries += 1
    alpha = chol_solve(LA, Kxu.T @ r) / sn2
    return Luu, LA, alpha, added, bool(chol_ok(Luu) & chol_ok(LA))


def _s2_raw(kernel, hyp, Ksu, Luu, LA, xs):
    """sf2 - diag(K*u (Kuu^-1 - A^-1) K*u^T), no sn2 (VFE.cpp:125-131)."""
    KinvK = chol_solve(Luu, Ksu.T) - chol_solve(LA, Ksu.T)
    sf2 = kernel.diag_k(hyp[:kernel.num_hyp(xs.shape[1])], xs)
    return sf2 - torch.sum(Ksu * KinvK.T, dim=1)


def predict(kernel, hyp, u, Luu, LA, alpha, xs):
    """Mean (VFE.cpp:113-117) and VFE variance (VFE.cpp:125-131):
    s2 = max(sf2 - diag(K*u (Kuu^-1 - A^-1) K*u^T), 0), NO sn2 added."""
    Ksu = kernel.k(hyp[:kernel.num_hyp(xs.shape[1])], xs, u)
    raw = _s2_raw(kernel, hyp, Ksu, Luu, LA, xs)
    return Ksu @ alpha + hyp_mean(hyp), torch.clamp(raw, min=0.0)


def predict_s2_with_grad(kernel, hyp, u, Luu, LA, xs):
    """Input gradient of the VFE variance (the reference ignores need_g,
    VFE.cpp:125-131; a superset, as gp_tpu's): the value floored at 0, the
    gradient through the floor."""
    xs = xs.detach().requires_grad_(True)
    with torch.enable_grad():
        Ksu = kernel.k(hyp[:kernel.num_hyp(xs.shape[1])], xs, u)
        raw = _s2_raw(kernel, hyp, Ksu, Luu, LA, xs)
        s2 = straight_through(raw, torch.clamp(raw, min=0.0))
        g, = torch.autograd.grad(s2.sum(), xs)
    return s2.detach(), g


# --------------------------------------------------------------------------
# Model class
# --------------------------------------------------------------------------

class VFE(SparseGPBase):
    """VFE sparse GP with the reference's public surface (VFE.h).

    `VFE(X, y)` runs on CUDA in float64; `VFE(X, y, device="cpu")` on the
    CPU.  Posterior cache: (Luu, LA, alpha)."""

    _MAX_EVAL = 150  # VFE.cpp:74
    _fns = SparseFns(nll_raw, set_k, predict, predict_s2_with_grad)

    def train(self, init_hyps=None) -> float:
        """VFE.cpp:94-101: uniquely among the models, a failed fit
        re-seeds through the global search and retries once."""
        nlz = super().train(init_hyps)
        if not np.isfinite(nlz):
            reseeded = self.select_init_hyp(self._num_hyp * 50,
                                            self.get_default_hyps())
            nlz = super().train(reseeded)
        return nlz

    def _update_posterior(self):
        Luu, LA, alpha, _, ok = self._set_k()
        if not ok:
            # VFE::_setK loops until SPD (VFE.cpp:146-158): it never
            # serves a failed factor
            raise RuntimeError(
                "VFE posterior factorization failed after jitter doubling "
                "(set_k exhausted max_tries); refusing to cache a NaN "
                "posterior")
        self._post = (Luu, LA, alpha)

    def test_obj(self, hyp, eps: float = 1e-6):
        """VFE::test_obj (VFE.cpp:254-282): analytic against
        finite-difference gradient; returns (nll, grad, grad_fd)."""
        return self._test_obj(hyp, eps)
