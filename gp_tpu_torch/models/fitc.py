"""FITC sparse GP (Snelson & Ghahramani; counterpart of
gp_tpu/models/fitc.py; reference: FITC.{h,cpp}).

The Woodbury/Nystrom algebra is O(N M^2) in GEMMs:

  Gamma = (sn2 + sf2 - diag(Kxu Kuu^-1 Kux)) / sn2          (FITC.cpp:215)
  A     = sn2 Kuu + Kux Gamma^-1 Kxu                        (FITC.cpp:217)
  NLL   = 0.5 [ y^T Gamma^-1 (y - Kxu A^-1 Kux Gamma^-1 y)/sn2
              + log|A| - log|Kuu| + sum log Gamma + (N-M) log sn2
              + N log 2pi ]                                  (FITC.cpp:220-227)

Kuu = K(U, U) and Kxu = K(X, U) are K2 builds (ops/se_tile.py); the
reference's analytic hyp gradient (FITC.cpp:237-315) is torch autograd of
this objective, as gp_tpu takes jax.value_and_grad (models/sparse.py).

Spans (utils/profiling.py), under sparse.value_and_grad's `objective`:
`objective.kxu` the builds of diag(Kxx), Kuu and Kxu; `objective.factor`
each M x M Cholesky (Luu, LA); `objective.nystrom` V = Luu^-1 Kux, its
column norms, Gamma and the weighted Gram Kux Gamma^-1 Kxu.  The
posterior (set_k) runs under `posterior`.
"""

from __future__ import annotations

import math

import torch

from ..ops.chol import chol_logdet, chol_ok, chol_solve, library_cholesky
from ..ops.chol import solve_lower
from ..utils.profiling import host_read, span
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
    """FITC::_calcNegLogProb (FITC.cpp:201-228); NaN/inf propagate.
    Under debug_decomp_enabled() prints gp_tpu's "fitc_nll" breakdown."""
    n, d = x.shape
    m = u.shape[0]
    nc = kernel.num_hyp(d)
    chyp = hyp[:nc]
    sn2 = hyp_sn2(hyp)
    r = y - hyp_mean(hyp)

    with span("objective.kxu"):
        sf2 = kernel.diag_k(chyp, x)
        Kuu = kernel.k(chyp, u, u) + jitter * eye_like(m, x)
        Kxu = kernel.k(chyp, x, u)

    with span("objective.factor"):
        Luu = library_cholesky(Kuu)
    with span("objective.nystrom"):
        V = solve_lower(Luu, Kxu.T)                 # (M, N): Luu^-1 Kux
        qdiag = torch.sum(V * V, dim=0)             # diag(Kxu Kuu^-1 Kux)
        # the Nystrom residual sf2 - qdiag is >= 0 mathematically; the
        # clamp suppresses rounding (it is 0 exactly when an inducing
        # point is a data point).  torch.maximum, as jnp.maximum, halves
        # the gradient at a tie
        gamma = 1.0 + torch.maximum(sf2 - qdiag, zero_like(sf2)) / sn2
        inv_gamma = 1.0 / gamma
        A = sn2 * Kuu + (Kxu.T * inv_gamma) @ Kxu   # (M, M)
    with span("objective.factor"):
        LA = library_cholesky(A)

    t1 = Kxu.T @ (inv_gamma * r)                    # (M,)
    fit_term = torch.dot(inv_gamma * r,
                         r - Kxu @ chol_solve(LA, t1)) / sn2
    complexity = (chol_logdet(LA) - chol_logdet(Luu)
                  + torch.sum(torch.log(gamma)) + (n - m) * torch.log(sn2))
    nlz = 0.5 * (fit_term + complexity + n * math.log(2 * math.pi))
    if debug_decomp_enabled():
        # gp_tpu's per-evaluation breakdown (fitc.py:68-74)
        debug_print_nll_decomp(
            "fitc_nll", nlz=nlz, data_fit=0.5 * fit_term,
            complexity=0.5 * complexity,
            norm_const=0.5 * n * math.log(2 * math.pi))
    return nlz


def nll(kernel, hyp, x, y, u, jitter):
    return inf_nll(nll_raw(kernel, hyp, x, y, u, jitter))


def objective_vg(kernel, noise_free: bool, vec, x, y, u, jitter):
    return value_and_grad(nll_raw, kernel, noise_free, vec, x, y, u, jitter)


def multistart_objective(kernel, noise_free: bool, vec, x, y, u, jitter):
    return search_value(nll_raw, kernel, noise_free, vec, x, y, u, jitter)


def fit(kernel, noise_free: bool, x, y, u, jitter, vec0, lb, ub,
        max_evals: int = 130):
    return local_fit(nll_raw, kernel, noise_free, x, y, u, jitter, vec0, lb,
                     ub, max_evals)


@torch.no_grad()
def set_k(kernel, hyp, x, y, u, jitter0, max_tries: int = 64):
    """FITC::_setK (FITC.cpp:165-200): factor Kuu + jI and A, doubling the
    jitter until both are SPD; the first attempt leaves A un-jittered, the
    retries add the jitter to A too (the reference's loop shape).  gp_tpu's
    while_loop is a Python loop with one host sync per try
    (profiling.host_read, "sparse_set_k").

    Returns (Luu, LA, alpha, jitter, ok)."""
    n, d = x.shape
    m = u.shape[0]
    nc = kernel.num_hyp(d)
    chyp = hyp[:nc]
    sn2 = hyp_sn2(hyp)
    r = y - hyp_mean(hyp)
    sf2 = kernel.diag_k(chyp, x)
    Kuu = kernel.k(chyp, u, u)
    Kxu = kernel.k(chyp, x, u)
    eye = eye_like(m, x)

    def attempt(jitter, a_jitter):
        Luu = library_cholesky(Kuu + jitter * eye)
        V = solve_lower(Luu, Kxu.T)
        qdiag = torch.sum(V * V, dim=0)
        inv_gamma = 1.0 / (1.0 + torch.maximum(sf2 - qdiag, zero_like(sf2))
                           / sn2)
        # A from the raw Kuu (FITC.cpp:180), unlike the NLL's jittered one
        A = sn2 * Kuu + (Kxu.T * inv_gamma) @ Kxu
        LA = library_cholesky(A + a_jitter * eye)
        return Luu, LA, inv_gamma

    def ok(Luu, LA):
        return host_read(chol_ok(Luu) & chol_ok(LA), "sparse_set_k")

    jitter = torch.as_tensor(jitter0, dtype=x.dtype, device=x.device)
    Luu, LA, inv_gamma = attempt(jitter, torch.zeros_like(jitter))
    good = ok(Luu, LA)
    tries = 0
    while not good and tries < max_tries:
        jitter = jitter * 2.0
        Luu, LA, inv_gamma = attempt(jitter, jitter)
        good = ok(Luu, LA)
        tries += 1
    alpha = chol_solve(LA, Kxu.T @ (inv_gamma * r))
    return Luu, LA, alpha, jitter, good


def _s2_raw(kernel, hyp, Ksu, Luu, LA, xs):
    """(sn2 + sf2 - diag(K*u (Kuu^-1 - sn2 A^-1) K*u^T), sn2)."""
    sn2 = hyp_sn2(hyp)
    KinvK = chol_solve(Luu, Ksu.T) - sn2 * chol_solve(LA, Ksu.T)
    sf2 = kernel.diag_k(hyp[:kernel.num_hyp(xs.shape[1])], xs)
    return sn2 + sf2 - torch.sum(Ksu * KinvK.T, dim=1), sn2


def predict(kernel, hyp, u, Luu, LA, alpha, xs):
    """FITC::_predict (FITC.cpp:109-117), O(M^2) per point:

    y*  = K*u alpha + mean
    s2* = max(sn2 + sf2 - diag(K*u (Kuu^-1 - sn2 A^-1) K*u^T), sn2)
    """
    Ksu = kernel.k(hyp[:kernel.num_hyp(xs.shape[1])], xs, u)   # (T, M)
    raw, sn2 = _s2_raw(kernel, hyp, Ksu, Luu, LA, xs)
    return Ksu @ alpha + hyp_mean(hyp), torch.maximum(raw, sn2)


def predict_s2_with_grad(kernel, hyp, u, Luu, LA, xs):
    """(s2, ds2/dx*) batched: the value clamped at sn2 (FITC.cpp:117), the
    gradient through the clamp, as the reference's analytic gs2
    (FITC.cpp:127)."""
    xs = xs.detach().requires_grad_(True)
    with torch.enable_grad():
        Ksu = kernel.k(hyp[:kernel.num_hyp(xs.shape[1])], xs, u)
        raw, sn2 = _s2_raw(kernel, hyp, Ksu, Luu, LA, xs)
        s2 = straight_through(raw, torch.maximum(raw, sn2))
        g, = torch.autograd.grad(s2.sum(), xs)
    return s2.detach(), g


# --------------------------------------------------------------------------
# Model class
# --------------------------------------------------------------------------

class FITC(SparseGPBase):
    """FITC sparse GP with the reference's public surface (FITC.h).

    `FITC(X, y)` runs on CUDA in float64; `FITC(X, y, device="cpu")` on the
    CPU.  Posterior cache: (Luu, LA, alpha)."""

    _MAX_EVAL = 130  # FITC.cpp:75
    _fns = SparseFns(nll_raw, set_k, predict, predict_s2_with_grad)

    def _update_posterior(self):
        with span("posterior"):
            Luu, LA, alpha, jitter, ok = self._set_k()
        if not ok:
            # FITC::_setK loops until SPD (FITC.cpp:184-198): it never
            # serves a failed factor
            raise RuntimeError(
                "FITC posterior factorization failed after jitter doubling "
                "(set_k exhausted max_tries); refusing to cache a NaN "
                "posterior")
        self._jitter_u = float(jitter)
        self._post = (Luu, LA, alpha)

    def test_obj(self, hyp, eps: float = 1e-3):
        """FITC::test_obj (FITC.cpp:324-352): analytic against
        finite-difference gradient; returns (nll, grad, grad_fd)."""
        return self._test_obj(hyp, eps)
