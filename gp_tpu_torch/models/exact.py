"""Exact Gaussian-process regression (counterpart of gp_tpu/models/exact.py;
reference: GP.{h,cpp}).

The path, as gp_tpu takes it off the TPU (its unblocked branch,
exact.py:186-215):

  objective   K + sn2 I in one kernel pass (K1, ops/se_tile.py), library
              Cholesky, explicit inverse, alpha = K^-1 r, and the
              structured gradient contraction (KernelSpec.k_noise_vjp_q,
              SE) or the vjp of the K1 build at Q = K^-1 - alpha alpha^T
              (Matern, RQ);
  posterior   set_k: K(X, X) through K2, then the sqrt(10) noise-inflation
              ladder until the factorization succeeds (GP.cpp:423-444);
  prediction  the cross-covariance K(X*, X) through K2, then solves.

Test-input gradients (GP.cpp:284-296): gp_tpu vmaps value_and_grad of a
single-point function.  Here the batch is written out: K(X*, X) is built
once with X* requiring grad, and autograd of mu.sum() (or s2.sum()) gives
every point's gradient, because row i depends on X*[i] alone.

Not ported here: the stream regime (N >= 32768: nll_vg_streamed,
set_k_streamed and the factor-as-temp predictions) is ROADMAP module 11,
and any N at or past that raises NotImplementedError; the far-pad decoy
and panel-blocked branches exist only for the TPU (see ops/blocked.py);
the distributed layer is module 14, the masked (bucketed) family module 10.
"""

from __future__ import annotations

import math

import torch

from ..config import DEFAULT_SEED, INF
from ..ops.blocked import add_diag, spd_inv_from_chol
from ..ops.chol import chol_logdet, cholesky
from ..ops.kernels import KernelSpec, get_k_noise
from ..ops.solvers import CHOL, SolverSpec
from ..optim.lbfgsb import lbfgsb_impl
from .base import (GPBase, from_opt_vec, hyp_mean, hyp_sn2,
                   sanitize_value_and_grad, to_opt_vec)

# Row count from which gp_tpu switches to its memory-streamed objective
# and posterior (exact.py:38-41), which compute a refined NLL.
_STREAM_MIN_N = 32768


def _check_n(n: int) -> None:
    if n >= _STREAM_MIN_N:
        raise NotImplementedError(
            f"N={n} >= {_STREAM_MIN_N} is gp_tpu's stream regime "
            f"(refined NLL, streamed posterior), ROADMAP module 11; it is "
            f"not ported yet")


def _half_n_log_2pi(n: int) -> float:
    return 0.5 * n * math.log(2 * math.pi)


# --------------------------------------------------------------------------
# Pure functions
# --------------------------------------------------------------------------

def nll_raw(kernel: KernelSpec, hyp, x, y, solver: SolverSpec = CHOL):
    """Negative log marginal likelihood; NaN/inf propagate.
    GP::_calcNegLogProb (GP.cpp:120-148)."""
    n = x.shape[0]
    _check_n(n)
    nc = kernel.num_hyp(x.shape[1])
    r = y - hyp_mean(hyp)
    K = get_k_noise(kernel)(hyp[:nc], hyp_sn2(hyp), x, n)
    f = solver.factor(K)
    alpha = solver.solve(f, r)
    return (0.5 * torch.dot(r, alpha) + 0.5 * solver.logdet(f)
            + _half_n_log_2pi(n))


def nll(kernel: KernelSpec, hyp, x, y, solver: SolverSpec = CHOL):
    v = nll_raw(kernel, hyp, x, y, solver)
    return torch.where(torch.isfinite(v), v, torch.full_like(v, INF))


def nll_vg_raw(kernel: KernelSpec, hyp, x, y):
    """NLL + analytic hyperparameter gradient via the explicit inverse
    (GP.cpp:120-176):

        Q = K^-1 - alpha alpha^T
        g_cov_i = 0.5 sum(Q o dK/dtheta_i);  g_noise = sn2 tr(Q);
        g_mean = -sum(alpha)

    The SE specs contract the gradient without forming Q
    (KernelSpec.k_noise_vjp_q); any other spec takes gp_tpu's generic
    branch (exact.py:203-209): Q is formed, in place of K^-1, and the vjp
    of the k_noise build at Q gives the (chyp, sn2) cotangents.

    NaN/inf propagate (the caller sanitizes).  Cholesky only.  No host
    sync: every scalar stays on the device."""
    n = x.shape[0]
    _check_n(n)
    nc = kernel.num_hyp(x.shape[1])
    chyp = hyp[:nc]
    sn2 = hyp_sn2(hyp)
    generic = kernel.k_noise_vjp_q is None
    # the generic branch differentiates the build at leaves of its own
    leaves = (chyp.detach().requires_grad_(generic),
              sn2.detach().requires_grad_(generic))
    with torch.set_grad_enabled(generic):
        K_build = get_k_noise(kernel)(*leaves, x, n)
    K = K_build.detach()
    L = cholesky(K)
    Kinv = spd_inv_from_chol(L)
    r = y - hyp_mean(hyp)
    # alpha from the (already needed) explicit inverse: one matvec
    alpha = Kinv @ r
    value = (0.5 * torch.dot(r, alpha) + 0.5 * chol_logdet(L)
             + _half_n_log_2pi(n))
    if generic:
        del L
        # Q = Kinv - alpha alpha^T, written over Kinv (dead from here)
        Q = Kinv.addr_(alpha, alpha, alpha=-1.0)
        g_cov_t, g_sn2 = torch.autograd.grad(K_build, leaves, Q)
        del Q, Kinv, K_build
    else:
        g_cov_t, g_sn2 = kernel.k_noise_vjp_q(chyp, sn2, x, n, K, Kinv,
                                              alpha)
    g_sn = sn2 * g_sn2        # = sn2 (tr(Kinv) - a^T a)
    g_mean = -torch.sum(alpha)
    grad = torch.cat([0.5 * g_cov_t,
                      torch.stack([g_sn, g_mean]).to(g_cov_t.dtype)])
    return value, grad


def objective_vg(kernel: KernelSpec, noise_free: bool, vec, x, y,
                 solver: SolverSpec = CHOL):
    """(value, grad) over the optimization vector, INF-sanitized."""
    if solver.name != "chol":
        raise NotImplementedError(
            f"solver {solver.name!r}: only 'chol' is ported (ROADMAP "
            f"module 12)")
    f, g_hyp = nll_vg_raw(kernel, from_opt_vec(vec, noise_free), x, y)
    return sanitize_value_and_grad(f, to_opt_vec(g_hyp, noise_free))


def multistart_objective(kernel: KernelSpec, noise_free: bool, vec, x, y,
                         solver: SolverSpec = CHOL):
    """NLL with the sn2 > mean(sf2) rejection (GP.cpp:470-471)."""
    hyp = from_opt_vec(vec, noise_free)
    nc = kernel.num_hyp(x.shape[1])
    sf2_mean = torch.mean(kernel.diag_k(hyp[:nc], x))
    v = nll_raw(kernel, hyp, x, y, solver)
    ok = torch.isfinite(v) & (hyp_sn2(hyp) <= sf2_mean)
    return torch.where(ok, v, torch.full_like(v, INF))


def fit(kernel: KernelSpec, noise_free: bool, x, y, vec0, lb, ub,
        max_evals: int = 160, solver: SolverSpec = CHOL):
    """The bounded local MLE optimization.

    Dtype contract: optimizer state runs in the DATA dtype; a float64 vec0
    over float32 data is cast down (gp_tpu exact.py:643-648)."""
    fun = lambda v: objective_vg(kernel, noise_free, v, x, y, solver)
    vec0, lb, ub = (torch.as_tensor(a).to(device=x.device, dtype=x.dtype)
                    for a in (vec0, lb, ub))
    return lbfgsb_impl(fun, vec0, lb, ub, max_evals=max_evals)


def set_k(kernel: KernelSpec, hyp, x, y, solver: SolverSpec = CHOL,
          max_tries: int = 64):
    """Posterior cache (GP::_setK, GP.cpp:423-444): factor K, inflating the
    noise until the solver accepts it (log_sn += log sqrt(10), restarting at
    log eps from -inf — GP.cpp:431-440), then cache invKys.

    gp_tpu's while_loop becomes a Python loop with one host sync per try.
    Returns (hyp', factors, invKys, ok): hyp' may carry inflated noise, as
    the reference mutates _hyps; ok=False means max_tries were exhausted
    (the caller must refuse to cache that posterior)."""
    _check_n(x.shape[0])
    nc = kernel.num_hyp(x.shape[1])
    Kcov = kernel.k(hyp[:nc], x, x)
    d0 = Kcov.diagonal().clone()
    log_eps = math.log(torch.finfo(x.dtype).eps)
    half_log10 = 0.5 * math.log(10.0)
    ls = hyp[-2].to(x.dtype)

    def factor(ls):
        # K0 + sn2 I on a fresh diagonal each try (Kcov is reused)
        Kcov.diagonal().copy_(d0)
        return solver.factor(add_diag(Kcov, torch.exp(2.0 * ls)))

    f = factor(ls)
    tries = 0
    while not bool(solver.ok(f)) and tries < max_tries:
        ls = (torch.full_like(ls, log_eps) if bool(torch.isinf(ls))
              else ls + half_log10)
        f = factor(ls)
        tries += 1
    hyp = hyp.clone()
    hyp[-2] = ls
    invKys = solver.solve(f, y - hyp_mean(hyp))
    return hyp, f, invKys, bool(solver.ok(f))


def predict(kernel: KernelSpec, hyp, x, f, invKys, xs,
            solver: SolverSpec = CHOL):
    """Batched posterior mean + variance (GP::_predict, GP.cpp:273-283).

    y*  = mean + k* invKys
    s2* = max(sf2 - sum(k* o K^-1 k*), 0) + sn2
    """
    chyp = hyp[:kernel.num_hyp(x.shape[1])]
    kt = kernel.k(chyp, xs, x)                    # (T, N)
    mu = hyp_mean(hyp) + kt @ invKys
    kks = solver.solve(f, kt.T)                   # (N, T)
    sf2 = kernel.diag_k(chyp, xs)
    s2 = torch.clamp(sf2 - torch.sum(kt * kks.T, dim=1), min=0.0) \
        + hyp_sn2(hyp)
    return mu, s2


def predict_y(kernel: KernelSpec, hyp, x, invKys, xs):
    """Mean-only path (GP::_predict_y, GP.cpp:298-314)."""
    kt = kernel.k(hyp[:kernel.num_hyp(x.shape[1])], xs, x)
    return hyp_mean(hyp) + kt @ invKys


def predict_s2(kernel: KernelSpec, hyp, x, f, xs, solver: SolverSpec = CHOL):
    """Variance-only path (GP::_predict_s2, GP.cpp:315-334)."""
    chyp = hyp[:kernel.num_hyp(x.shape[1])]
    kt = kernel.k(chyp, xs, x)
    kks = solver.solve(f, kt.T)
    sf2 = kernel.diag_k(chyp, xs)
    return torch.clamp(sf2 - torch.sum(kt * kks.T, dim=1), min=0.0) \
        + hyp_sn2(hyp)


def predict_y_with_grad(kernel: KernelSpec, hyp, x, invKys, xs):
    """(y, dy/dx*) batched over test points — the BO acquisition path
    (GP.cpp:289-293)."""
    xs = xs.detach().requires_grad_(True)
    with torch.enable_grad():
        mu = predict_y(kernel, hyp, x, invKys, xs)
        g, = torch.autograd.grad(mu.sum(), xs)
    return mu.detach(), g


def predict_s2_with_grad(kernel: KernelSpec, hyp, x, f, xs,
                         solver: SolverSpec = CHOL):
    """(s2, ds2/dx*) batched over test points.  The value is clamped at 0
    (GP.cpp:283); the gradient ignores the clamp, exactly as the
    reference's analytic gs2 does (GP.cpp:294): a straight-through clamp,
    as gp_tpu's _predict_s2_single."""
    chyp = hyp[:kernel.num_hyp(x.shape[1])]
    xs = xs.detach().requires_grad_(True)
    with torch.enable_grad():
        kt = kernel.k(chyp, xs, x)
        kks = solver.solve(f, kt.T)
        quad = torch.sum(kt * kks.T, dim=1)
        sf2 = kernel.diag_k(chyp, xs)
        raw = sf2 - quad + hyp_sn2(hyp)
        clamped = torch.clamp(sf2 - quad, min=0.0) + hyp_sn2(hyp)
        s2 = raw + (clamped - raw).detach()
        g, = torch.autograd.grad(s2.sum(), xs)
    return s2.detach(), g


# --------------------------------------------------------------------------
# Model class
# --------------------------------------------------------------------------

class GP(GPBase):
    """Exact GP with the reference's public API surface (GP.h:79-122).

    `GP(X, y)` runs on CUDA in float32; `GP(X, y, device="cpu")` on the
    CPU in float64.  Only the "chol" solver is ported.
    """

    _MAX_EVAL = 160

    def __init__(self, train_x, train_y, kernel="se_ard", dtype=None,
                 seed: int = DEFAULT_SEED, solver="chol", device=None):
        super().__init__(train_x, train_y, kernel=kernel, dtype=dtype,
                         seed=seed, solver=solver, device=device)
        _check_n(self.num_train)

    def add_data(self, x, y):
        super().add_data(x, y)
        _check_n(self.num_train)

    def _nll_value(self, hyp):
        return nll(self.kernel, hyp, self._x, self._y, self.solver)

    def _objective_closure(self):
        kernel, noise_free = self.kernel, self._noise_free
        x, y, solver = self._x, self._ys, self.solver
        return lambda v: objective_vg(kernel, noise_free, v, x, y, solver)

    def _run_local_opt(self, vec0, lb_v, ub_v):
        return fit(self.kernel, self._noise_free, self._x, self._ys,
                   vec0, lb_v, ub_v, max_evals=self._MAX_EVAL,
                   solver=self.solver)

    def _update_posterior(self):
        hyp, f, invKys, ok = set_k(self.kernel, self._hyps, self._x,
                                   self._y, self.solver)
        if not ok:
            # reference parity: _setK loops until the factorization
            # succeeds (GP.cpp:423-444) and never serves a failed factor
            raise RuntimeError(
                "posterior factorization failed after noise inflation "
                "(set_k exhausted max_tries); refusing to cache a NaN "
                "posterior")
        self._post = (*f, invKys)
        self._hyps = hyp

    def _factors(self):
        return tuple(self._post[:-1])

    # -- prediction API (GP.h:104-119); tensors on the model's device --------
    def batch_predict(self, xs):
        self._require_trained()
        return predict(self.kernel, self._hyps, self._x, self._factors(),
                       self._post[-1], self._as_batch(xs), self.solver)

    def batch_predict_y(self, xs):
        self._require_trained()
        return predict_y(self.kernel, self._hyps, self._x, self._post[-1],
                         self._as_batch(xs))

    def batch_predict_s2(self, xs):
        self._require_trained()
        return predict_s2(self.kernel, self._hyps, self._x, self._factors(),
                          self._as_batch(xs), self.solver)

    def batch_predict_y_with_grad(self, xs):
        self._require_trained()
        return predict_y_with_grad(self.kernel, self._hyps, self._x,
                                   self._post[-1], self._as_batch(xs))

    def batch_predict_s2_with_grad(self, xs):
        self._require_trained()
        return predict_s2_with_grad(self.kernel, self._hyps, self._x,
                                    self._factors(), self._as_batch(xs),
                                    self.solver)

