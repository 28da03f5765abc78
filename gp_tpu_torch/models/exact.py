"""Exact Gaussian-process regression (counterpart of gp_tpu/models/exact.py;
reference: GP.{h,cpp}).

The path, as gp_tpu takes it (exact.py:157-215):

  objective   K + sn2 I in one kernel pass (K1, ops/se_tile.py), the
              Cholesky factor, the explicit inverse, alpha = K^-1 r, and
              the structured gradient contraction (KernelSpec.k_noise_vjp_q,
              SE) or the vjp of the K1 build at Q = K^-1 - alpha alpha^T
              (Matern, RQ).  chol.factor_and_inverse picks the route: on
              a CUDA device from chol._BLOCKED_MIN_N rows gp_tpu's
              accelerator branch (K padded once to the panel multiple,
              blocked_cholesky with its per-panel diagonal inverses, K3
              leaves, and the blocked lauum spd_inv_from_chol), elsewhere
              the library factor and `cholesky_inverse`;
  posterior   set_k: K(X, X) through K2, then the sqrt(10) noise-inflation
              ladder until the factorization succeeds (GP.cpp:423-444);
              chol.cholesky routes it as above;
  prediction  the cross-covariance K(X*, X) through K2, then solves.

Test-input gradients (GP.cpp:284-296): gp_tpu vmaps value_and_grad of a
single-point function.  Here the batch is written out: K(X*, X) is built
once with X* requiring grad, and autograd of mu.sum() (or s2.sum()) gives
every point's gradient, because row i depends on X*[i] alone.

Under GP_TPU_DEBUG=1 and GP_TPU_VERBOSE_OPT=1 (base.debug_decomp_enabled)
nll_raw and nll_vg_raw print gp_tpu's per-evaluation NLL breakdown; off,
they add no host sync.  The masked family at the end of the module
(BucketedGP's) computes on the live rows of a capacity buffer.

Not ported here: the stream regime (N >= 32768: nll_vg_streamed,
set_k_streamed and the factor-as-temp predictions) is ROADMAP module 11,
and any N at or past that raises NotImplementedError; gp_tpu's far-pad
decoy branch (exact.py:218-309) avoids XLA:TPU's pad and slice costs and
is not carried: every spec pads once instead; the distributed layer is
module 14.
"""

from __future__ import annotations

import math

import torch

from ..config import DEFAULT_SEED, INF
from ..ops.blocked import add_diag, eye_pad
from ..ops.chol import (chol_logdet, factor_and_inverse, solve_lower,
                        solve_lower_t)
from ..ops.kernels import KernelSpec, get_k_noise
from ..ops.solvers import CHOL, SolverSpec
from ..optim.lbfgsb import lbfgsb_impl
from .base import (GPBase, debug_decomp_enabled, debug_print_nll_decomp,
                   from_opt_vec, hyp_mean, hyp_sn2, sanitize_value_and_grad,
                   to_opt_vec)

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

def _nll_terms(kernel: KernelSpec, hyp, x, y, solver: SolverSpec):
    """(data_fit, half_logdet, norm_const) of the NLL at hyp."""
    n = x.shape[0]
    _check_n(n)
    nc = kernel.num_hyp(x.shape[1])
    r = y - hyp_mean(hyp)
    K = get_k_noise(kernel)(hyp[:nc], hyp_sn2(hyp), x, n)
    f = solver.factor(K)
    alpha = solver.solve(f, r)
    return (0.5 * torch.dot(r, alpha), 0.5 * solver.logdet(f),
            _half_n_log_2pi(n))


def _print_decomp(tag: str, data_fit, half_logdet, norm_const) -> None:
    debug_print_nll_decomp(tag, nlz=data_fit + half_logdet + norm_const,
                           data_fit=data_fit, half_logdet=half_logdet,
                           norm_const=norm_const)


def nll_raw(kernel: KernelSpec, hyp, x, y, solver: SolverSpec = CHOL,
            decomp: bool = True):
    """Negative log marginal likelihood; NaN/inf propagate.
    GP::_calcNegLogProb (GP.cpp:120-148).  Under debug_decomp_enabled()
    prints gp_tpu's "nll" breakdown (exact.py:113-118), unless decomp is
    False (the masked family's callers: gp_tpu's prints nothing)."""
    data_fit, half_logdet, norm_const = _nll_terms(kernel, hyp, x, y,
                                                   solver)
    if decomp and debug_decomp_enabled():
        _print_decomp("nll", data_fit, half_logdet, norm_const)
    return data_fit + half_logdet + norm_const


def nll(kernel: KernelSpec, hyp, x, y, solver: SolverSpec = CHOL,
        decomp: bool = True):
    v = nll_raw(kernel, hyp, x, y, solver, decomp)
    return torch.where(torch.isfinite(v), v, torch.full_like(v, INF))


def nll_vg_raw(kernel: KernelSpec, hyp, x, y, blocked=None,
               decomp: bool = True):
    """NLL + analytic hyperparameter gradient via the explicit inverse
    (GP.cpp:120-176):

        Q = K^-1 - alpha alpha^T
        g_cov_i = 0.5 sum(Q o dK/dtheta_i);  g_noise = sn2 tr(Q);
        g_mean = -sum(alpha)

    The SE specs contract the gradient without forming Q
    (KernelSpec.k_noise_vjp_q); any other spec takes gp_tpu's generic
    branch (exact.py:203-209): Q is formed, in place of K^-1, and the vjp
    of the k_noise build at Q gives the (chyp, sn2) cotangents.

    blocked: the factor's route, as chol.factor_and_inverse takes it
    (None: by size and device).  NaN/inf propagate (the caller
    sanitizes).  Cholesky only.  No host sync: every scalar stays on the
    device, unless debug_decomp_enabled(), which prints gp_tpu's "nll_vg"
    breakdown (exact.py:198-202); decomp=False keeps it silent, as
    nll_raw's."""
    value, grad, terms = _nll_vg_terms(kernel, hyp, x, y, blocked)
    if decomp and debug_decomp_enabled():
        _print_decomp("nll_vg", *terms)
    return value, grad


def _nll_vg_terms(kernel: KernelSpec, hyp, x, y, blocked):
    """(value, grad, (data_fit, half_logdet, norm_const)) of nll_vg_raw."""
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
    L, Kinv = factor_and_inverse(K, blocked)
    r = y - hyp_mean(hyp)
    # alpha from the (already needed) explicit inverse: one matvec
    alpha = Kinv @ r
    terms = (0.5 * torch.dot(r, alpha), 0.5 * chol_logdet(L),
             _half_n_log_2pi(n))
    value = terms[0] + terms[1] + terms[2]
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
    return value, grad, terms


def objective_vg(kernel: KernelSpec, noise_free: bool, vec, x, y,
                 solver: SolverSpec = CHOL, blocked=None,
                 decomp: bool = True):
    """(value, grad) over the optimization vector, INF-sanitized; blocked
    and decomp as in nll_vg_raw."""
    if solver.name != "chol":
        raise NotImplementedError(
            f"solver {solver.name!r}: only 'chol' is ported (ROADMAP "
            f"module 12)")
    f, g_hyp = nll_vg_raw(kernel, from_opt_vec(vec, noise_free), x, y,
                          blocked, decomp)
    return sanitize_value_and_grad(f, to_opt_vec(g_hyp, noise_free))


def multistart_objective(kernel: KernelSpec, noise_free: bool, vec, x, y,
                         solver: SolverSpec = CHOL, decomp: bool = True):
    """NLL with the sn2 > mean(sf2) rejection (GP.cpp:470-471)."""
    hyp = from_opt_vec(vec, noise_free)
    nc = kernel.num_hyp(x.shape[1])
    sf2_mean = torch.mean(kernel.diag_k(hyp[:nc], x))
    v = nll_raw(kernel, hyp, x, y, solver, decomp)
    ok = torch.isfinite(v) & (hyp_sn2(hyp) <= sf2_mean)
    return torch.where(ok, v, torch.full_like(v, INF))


def fit(kernel: KernelSpec, noise_free: bool, x, y, vec0, lb, ub,
        max_evals: int = 160, solver: SolverSpec = CHOL,
        decomp: bool = True):
    """The bounded local MLE optimization.

    Dtype contract: optimizer state runs in the DATA dtype; a float64 vec0
    over float32 data is cast down (gp_tpu exact.py:643-648)."""
    fun = lambda v: objective_vg(kernel, noise_free, v, x, y, solver,
                                 decomp=decomp)
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
    # whether the objective prints the NLL breakdown under
    # debug_decomp_enabled() (BucketedGP's does not, as gp_tpu's)
    _DECOMP = True

    def __init__(self, train_x, train_y, kernel="se_ard", dtype=None,
                 seed: int = DEFAULT_SEED, solver="chol", device=None):
        super().__init__(train_x, train_y, kernel=kernel, dtype=dtype,
                         seed=seed, solver=solver, device=device)
        _check_n(self.num_train)

    def add_data(self, x, y):
        super().add_data(x, y)
        _check_n(self.num_train)

    def _nll_value(self, hyp):
        return nll(self.kernel, hyp, self._x, self._y, self.solver,
                   self._DECOMP)

    def _objective_closure(self):
        kernel, noise_free, decomp = self.kernel, self._noise_free, \
            self._DECOMP
        x, y, solver = self._x, self._ys, self.solver
        return lambda v: objective_vg(kernel, noise_free, v, x, y, solver,
                                      decomp=decomp)

    def _multistart_objective(self):
        kernel, noise_free, decomp = self.kernel, self._noise_free, \
            self._DECOMP
        x, y, solver = self._x, self._ys, self.solver
        return lambda vecs: torch.stack([multistart_objective(
            kernel, noise_free, v, x, y, solver, decomp) for v in vecs])

    def _run_local_opt(self, vec0, lb_v, ub_v):
        return fit(self.kernel, self._noise_free, self._x, self._ys,
                   vec0, lb_v, ub_v, max_evals=self._MAX_EVAL,
                   solver=self.solver, decomp=self._DECOMP)

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

    def _inv_kys(self):
        return self._post[-1]

    # -- prediction API (GP.h:104-119); tensors on the model's device --------
    def batch_predict(self, xs):
        self._require_trained()
        return predict(self.kernel, self._hyps, self._x, self._factors(),
                       self._inv_kys(), self._as_batch(xs), self.solver)

    def batch_predict_y(self, xs):
        self._require_trained()
        return predict_y(self.kernel, self._hyps, self._x, self._inv_kys(),
                         self._as_batch(xs))

    def batch_predict_s2(self, xs):
        self._require_trained()
        return predict_s2(self.kernel, self._hyps, self._x, self._factors(),
                          self._as_batch(xs), self.solver)

    def batch_predict_y_with_grad(self, xs):
        self._require_trained()
        return predict_y_with_grad(self.kernel, self._hyps, self._x,
                                   self._inv_kys(), self._as_batch(xs))

    def batch_predict_s2_with_grad(self, xs):
        self._require_trained()
        return predict_s2_with_grad(self.kernel, self._hyps, self._x,
                                    self._factors(), self._as_batch(xs),
                                    self.solver)


# --------------------------------------------------------------------------
# Masked-capacity family (gp_tpu exact.py:1420-1606), for BucketedGP
# --------------------------------------------------------------------------
#
# gp_tpu runs these over a fixed-capacity buffer whose live row count is a
# traced scalar, so that adding a point re-runs the same compiled program;
# the pad rows are identity-masked (K_pad = blockdiag(K, I), r_pad = 0),
# which gives the live rows' NLL, gradient and posterior exactly.  The
# port has no trace to keep: BucketedGP's objective, fit and predictions
# are GP's over views of the live rows, and the functions here take
# gp_tpu's arguments and compute on x_pad[:n_real] through the functions
# above (K1, the blocked route with its K3 leaves, K2).  Only the
# posterior factor keeps gp_tpu's capacity layout, blockdiag(L, I), so
# that append_posterior_masked writes one row in place.  These print no
# NLL breakdown, as gp_tpu's do not.

def _masked_k(kernel: KernelSpec, chyp, x_pad, n_real: int):
    """K0 over the buffer with identity pad rows and columns,
    blockdiag(K(X, X), I): the layout of the capacity factor."""
    x = x_pad[:n_real]
    return eye_pad(kernel.k(chyp, x, x), x_pad.shape[0] - n_real)


def nll_raw_masked(kernel: KernelSpec, hyp, x_pad, y_pad, n_real: int,
                   solver: SolverSpec = CHOL):
    """NLL over the first n_real rows of a buffer."""
    return nll_raw(kernel, hyp, x_pad[:n_real], y_pad[:n_real], solver,
                   decomp=False)


def nll_vg_raw_masked(kernel: KernelSpec, hyp, x_pad, y_pad, n_real: int,
                      blocked=None):
    """nll_vg_raw over the first n_real rows of a buffer."""
    return nll_vg_raw(kernel, hyp, x_pad[:n_real], y_pad[:n_real], blocked,
                      decomp=False)


def set_k_masked(kernel: KernelSpec, hyp, x_pad, y_pad, n_real: int,
                 solver: SolverSpec = CHOL, max_tries: int = 64):
    """set_k over the first n_real rows, returned in the buffer's layout:
    (hyp', (blockdiag(L, I),), invKys zero-padded, ok), at the buffer's
    row count.  The factor is copied into a buffer of its own (on the
    blocked route chol.cholesky's L is a view of the panel-padded
    factor)."""
    cap = x_pad.shape[0]
    hyp, f, invKys, ok = set_k(kernel, hyp, x_pad[:n_real],
                               y_pad[:n_real], solver, max_tries)
    pad = cap - n_real
    return (hyp, tuple(eye_pad(a, pad) for a in f),
            torch.cat([invKys, invKys.new_zeros(pad)]), ok)


def append_posterior_masked(kernel: KernelSpec, hyp, x_pad, y_pad,
                            n_old: int, L, x_new, y_new):
    """The O(cap^2) posterior append: one new point enters the factor.

    With L = blockdiag(L_real, I) at the buffer's size, appending the
    point at row n_old writes one row of L:

        l          = L_real^-1 k(X, x_new)
        L[n_old, :] = [l, sqrt(k(x, x) + sn2 - |l|^2)]

    then invKys is solved again over the raw targets (two triangular
    solves), in place of set_k_masked's O(cap^3) refactorization.  The
    three solves run over the whole (contiguous) buffer with the vectors
    zero past the live rows, which leaves them zero there.  x_pad, y_pad
    and L are written in place (gp_tpu returns updated copies).

    Returns (x_pad, y_pad, L, invKys, ok); ok (a 0-d bool tensor) is False
    when the pivot is not positive: the caller refactorizes."""
    nc = kernel.num_hyp(x_pad.shape[1])
    chyp = hyp[:nc]
    cap = x_pad.shape[0]
    x_pad[n_old] = x_new
    y_pad[n_old] = y_new
    kvec = L.new_zeros(cap)
    kvec[:n_old] = kernel.k(chyp, x_new[None, :], x_pad[:n_old])[0]
    l = solve_lower(L, kvec)                                # pads -> 0
    knn = kernel.diag_k(chyp, x_new[None, :])[0] + hyp_sn2(hyp)
    piv2 = knn - torch.dot(l, l)
    ok = piv2 > 0
    l[n_old] = torch.sqrt(torch.clamp(piv2, min=0.0))
    # the row is written only with a positive pivot (on the device, no
    # sync): otherwise L keeps its identity row, the old factor, for the
    # caller's refactorization and for the model should that fail
    L[n_old, :n_old + 1] = torch.where(ok, l[:n_old + 1],
                                       L[n_old, :n_old + 1])
    r = L.new_zeros(cap)
    r[:n_old + 1] = y_pad[:n_old + 1] - hyp_mean(hyp)
    invKys = solve_lower_t(L, solve_lower(L, r))
    return x_pad, y_pad, L, invKys, ok
