"""Shared machinery of the sparse inducing-point models FITC and VFE
(counterpart of gp_tpu/models/sparse.py; reference: FITC.{h,cpp},
VFE.{h,cpp}).

Both models inherit the GP pipeline (models/base.py), hold an inducing set
U (by default the whole training set, FITC.cpp:12-13) and a jitter that
starts at (0.1 noise_lb)^2 at train time (FITC.cpp:27-31) and doubles on an
SPD failure in the posterior step.  Neither supports noise-free mode
(FITC.cpp:36-40, VFE.cpp:35-39): train() switches it off with gp_tpu's
warning, as the reference does.

Both default to float64 on every device, as gp_tpu's do: FITC's Gamma
divides the Nystrom residual sf2 - diag(Kxu Kuu^-1 Kux) by sn2, and for
inducing points at or near data points that residual is a cancellation
whose float32 rounding swamps small noise variances.  Pass
dtype="float32" to override.

Gradients are torch autograd through the objective, as gp_tpu takes
jax.value_and_grad: the covariance builds (K2, ops/se_tile.py) carry
gp_tpu's closed-form VJP; the factors and solves are the library's
(`cholesky_ex`, `cholesky_solve`, `solve_triangular`) on every device,
with their own autograd (the blocked route's K3 leaves have no backward).

Not carried: `_use_hosted_opt` and `_run_local_opt_guarded` (gp_tpu's
route around its TPU runtime's execution watchdog; the port's optimizer
is a host loop already); the per-evaluation NLL breakdown that gp_tpu
prints under GP_TPU_DEBUG=1 and GP_TPU_VERBOSE_OPT=1, as the port's exact
GP does not carry it; and `train_distributed`, ROADMAP module 14.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import DEFAULT_SEED, INF
from ..optim.lbfgsb import lbfgsb_impl
from .base import (GPBase, _np, from_opt_vec, hyp_mean, hyp_sn2,
                   sanitize_value_and_grad)

# ---------------------------------------------------------------------------
# The (N, M) memory envelope (gp_tpu/models/sparse.py:22-63)
#
# The objectives hold dense (N, M) panels: Kxu, V = Luu^-1 Kux, the
# Gamma-weighted Kxu^T operand and, under the gradient, a cotangent for
# each; with the GEMM operands' scratch gp_tpu counts ~8 live (N, M)
# buffers at peak.  The guard refuses work whose estimate exceeds the
# device's budget, loud at the model instead of out of memory mid-fit.
# GP_TPU_HBM_BYTES overrides the budget.  The one deliberate deviation from
# gp_tpu: the default follows the device.  On CUDA it is
# CUDA_BUDGET_SHARE of the card's memory (torch.cuda.get_device_properties
# .total_memory), the share gp_tpu's 12 GiB is of its 16 GB device; on the
# CPU it is gp_tpu's 12 GiB.
# ---------------------------------------------------------------------------

SPARSE_PANEL_FACTOR = 8
CUDA_BUDGET_SHARE = 0.75
CPU_BUDGET_BYTES = 12 * 2 ** 30


def hbm_budget_bytes(device=None) -> int:
    """The byte budget of check_nm_envelope on `device` (default: CPU):
    GP_TPU_HBM_BYTES if set, else CUDA_BUDGET_SHARE of a CUDA card's
    memory, else gp_tpu's 12 GiB.  Following the device is the one
    deliberate deviation from gp_tpu, whose default is its TPU's."""
    env = os.environ.get("GP_TPU_HBM_BYTES")
    if env is not None:
        return int(env)
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda":
        total = torch.cuda.get_device_properties(dev).total_memory
        return int(CUDA_BUDGET_SHARE * total)
    return CPU_BUDGET_BYTES


def check_nm_envelope(n: int, m: int, itemsize: int, n_dev: int = 1,
                      device=None) -> None:
    """Refuse sparse-model work whose estimated peak (N, M)-panel
    footprint exceeds the per-device budget (fail loud, not out of memory
    mid-fit)."""
    peak = SPARSE_PANEL_FACTOR * n * m * itemsize // max(n_dev, 1)
    budget = hbm_budget_bytes(device)
    if peak > budget:
        max_n = budget * max(n_dev, 1) // (SPARSE_PANEL_FACTOR * m * itemsize)
        raise ValueError(
            f"sparse-model (N, M) working set estimate "
            f"{peak / 2**30:.1f} GiB/device (N={n}, M={m}, "
            f"itemsize={itemsize}, {n_dev} device(s), "
            f"~{SPARSE_PANEL_FACTOR} live panels) exceeds the "
            f"{budget / 2**30:.1f} GiB HBM budget; shard rows over more "
            f"devices (train_distributed), reduce M, or raise "
            f"GP_TPU_HBM_BYTES (max N at this M and device count: "
            f"{max_n})")


# ---------------------------------------------------------------------------
# Pieces FITC and VFE share, over a model's nll_raw
# ---------------------------------------------------------------------------

def eye_like(m: int, x):
    return torch.eye(m, dtype=x.dtype, device=x.device)


def zero_like(t):
    """A 0-d zero of t's dtype and device (torch.maximum takes tensors)."""
    return torch.zeros((), dtype=t.dtype, device=t.device)


def inf_nll(v):
    """INF for a non-finite NLL."""
    return torch.where(torch.isfinite(v), v, torch.full_like(v, INF))


def value_and_grad(nll_raw, kernel, noise_free: bool, vec, x, y, u, jitter):
    """(value, grad) of nll_raw over the optimization vector by autograd
    (gp_tpu: jax.value_and_grad), INF-sanitized."""
    v = vec.detach().requires_grad_(True)
    with torch.enable_grad():
        f = nll_raw(kernel, from_opt_vec(v, noise_free), x, y, u, jitter)
        g, = torch.autograd.grad(f, v)
    return sanitize_value_and_grad(f.detach(), g)


def search_value(nll_raw, kernel, noise_free: bool, vec, x, y, u, jitter):
    """The NLL with the sn2 > mean(sf2) rejection (GP.cpp:470-471)."""
    hyp = from_opt_vec(vec, noise_free)
    nc = kernel.num_hyp(x.shape[1])
    sf2_mean = torch.mean(kernel.diag_k(hyp[:nc], x))
    v = nll_raw(kernel, hyp, x, y, u, jitter)
    ok = torch.isfinite(v) & (hyp_sn2(hyp) <= sf2_mean)
    return torch.where(ok, v, torch.full_like(v, INF))


def local_fit(nll_raw, kernel, noise_free: bool, x, y, u, jitter, vec0, lb,
              ub, max_evals: int):
    """The bounded local fit; optimizer state in the data dtype (see
    exact.fit)."""
    fun = lambda v: value_and_grad(nll_raw, kernel, noise_free, v, x, y, u,
                                   jitter)
    vec0, lb, ub = (torch.as_tensor(a).to(device=x.device, dtype=x.dtype)
                    for a in (vec0, lb, ub))
    return lbfgsb_impl(fun, vec0, lb, ub, max_evals=max_evals)


def predict_y(kernel, hyp, u, alpha, xs):
    """Posterior mean K*u alpha + mean (FITC.cpp:113, VFE.cpp:113-117)."""
    nc = kernel.num_hyp(xs.shape[1])
    return kernel.k(hyp[:nc], xs, u) @ alpha + hyp_mean(hyp)


def predict_y_with_grad(kernel, hyp, u, alpha, xs):
    """(y, dy/dx*) batched over test points: K(X*, U) built once with X*
    requiring grad; row i depends on X*[i] alone, so autograd of mu.sum()
    gives every point's gradient (gp_tpu vmaps a one-point function)."""
    xs = xs.detach().requires_grad_(True)
    with torch.enable_grad():
        mu = predict_y(kernel, hyp, u, alpha, xs)
        g, = torch.autograd.grad(mu.sum(), xs)
    return mu.detach(), g


def straight_through(raw, clamped):
    """clamped's value with raw's gradient (jax.lax.stop_gradient form)."""
    return raw + (clamped - raw).detach()


class SparseFns(NamedTuple):
    """A sparse model's own functions (models/fitc.py, models/vfe.py)."""
    nll_raw: Callable
    set_k: Callable
    predict: Callable
    predict_s2_with_grad: Callable


# ---------------------------------------------------------------------------
# Model base
# ---------------------------------------------------------------------------

class SparseGPBase(GPBase):
    """State and pipeline of FITC and VFE.  A subclass sets `_fns`, its
    module's SparseFns, `_MAX_EVAL` and `_update_posterior`."""

    _fns: SparseFns

    def __init__(self, train_x, train_y, kernel="se_ard", dtype=None,
                 seed: int = DEFAULT_SEED, solver="chol", device=None):
        super().__init__(train_x, train_y, kernel=kernel,
                         dtype="float64" if dtype is None else dtype,
                         seed=seed, solver=solver, device=device)
        self._u = self._x            # inducing default: full training set
        self._jitter_u = (0.1 * self._noise_lb) ** 2

    @property
    def num_inducing(self) -> int:
        return int(self._u.shape[0])

    @property
    def inducing(self):
        return self._u

    def set_inducing(self, u):
        """FITC::set_inducing (FITC.cpp:22-26); cast to the model's dtype
        and device."""
        u = self._tensor(np.asarray(_np(u), np.float64))
        if u.ndim != 2 or u.shape[1] != self._dim:
            raise ValueError(f"inducing points must be (M, {self._dim})")
        self._u = u
        self._trained = False

    @property
    def _jitter_std(self) -> float:
        """Jitter in the standardized-y space: Kuu scales by 1/sigma^2."""
        return self._jitter_u / (self._y_sigma ** 2)

    def _reset_jitter(self):
        """FITC::_init (FITC.cpp:27-31): jitter re-derived at train start."""
        self._jitter_u = (0.1 * self._noise_lb) ** 2

    def _check_envelope(self, n_dev: int = 1) -> None:
        check_nm_envelope(self.num_train, self.num_inducing,
                          self._x.element_size(), n_dev, self._device)

    def _refuse_noise_free(self):
        if self._noise_free:
            warnings.warn(f"{type(self).__name__} can't be noise free; "
                          "disabling noise-free mode (reference behavior)")
            self._noise_free = False  # FITC.cpp:36-40: flag off, noise_lb kept

    def train(self, init_hyps=None) -> float:
        self._refuse_noise_free()
        self._check_envelope()
        self._reset_jitter()
        return super().train(init_hyps)

    def train_multistart(self, n_starts: int = 8, init_hyps=None) -> float:
        self._refuse_noise_free()
        self._check_envelope()
        self._reset_jitter()
        return super().train_multistart(n_starts=n_starts,
                                        init_hyps=init_hyps)

    def train_distributed(self, mesh, init_hyps=None) -> float:
        raise NotImplementedError(
            "train_distributed (rows sharded over devices, gp_tpu's "
            "parallel/psparse.py) is ROADMAP module 14; it is not ported yet")

    # -- the pipeline's hooks -------------------------------------------------
    def _nll_value(self, hyp):
        return inf_nll(self._fns.nll_raw(self.kernel, hyp, self._x, self._y,
                                         self._u, self._tensor(self._jitter_u)))

    def _multistart_objective(self):
        nll_raw, kernel, nf = self._fns.nll_raw, self.kernel, self._noise_free
        x, y, u = self._x, self._ys, self._u
        jit = self._tensor(self._jitter_std)
        return lambda vecs: torch.stack([search_value(
            nll_raw, kernel, nf, v, x, y, u, jit) for v in vecs])

    def _objective_closure(self):
        nll_raw, kernel, nf = self._fns.nll_raw, self.kernel, self._noise_free
        x, y, u = self._x, self._ys, self._u
        jit = self._tensor(self._jitter_std)
        return lambda v: value_and_grad(nll_raw, kernel, nf, v, x, y, u, jit)

    def _run_local_opt(self, vec0, lb_v, ub_v):
        return local_fit(self._fns.nll_raw, self.kernel, self._noise_free,
                         self._x, self._ys, self._u,
                         self._tensor(self._jitter_std), vec0, lb_v, ub_v,
                         self._MAX_EVAL)

    def _set_k(self):
        """(Luu, LA, alpha, jitter, ok) of the model's set_k at the fitted
        hyps, in original units."""
        return self._fns.set_k(self.kernel, self._hyps, self._x, self._y,
                               self._u, self._tensor(self._jitter_u))

    # -- prediction API; tensors on the model's device ------------------------
    def batch_predict(self, xs):
        self._require_trained()
        Luu, LA, alpha = self._post
        return self._fns.predict(self.kernel, self._hyps, self._u, Luu, LA,
                                 alpha, self._as_batch(xs))

    def batch_predict_y(self, xs):
        self._require_trained()
        return predict_y(self.kernel, self._hyps, self._u, self._post[2],
                         self._as_batch(xs))

    def batch_predict_s2(self, xs):
        return self.batch_predict(xs)[1]

    def batch_predict_y_with_grad(self, xs):
        self._require_trained()
        return predict_y_with_grad(self.kernel, self._hyps, self._u,
                                   self._post[2], self._as_batch(xs))

    def batch_predict_s2_with_grad(self, xs):
        self._require_trained()
        Luu, LA, _ = self._post
        return self._fns.predict_s2_with_grad(self.kernel, self._hyps,
                                              self._u, Luu, LA,
                                              self._as_batch(xs))

    def _test_obj(self, hyp, eps: float):
        """Analytic (autograd) against central-difference NLL gradient at
        hyp, original units: (nll, grad, grad_fd)."""
        h = self._tensor(np.asarray(_np(hyp), np.float64))
        jit = self._tensor(self._jitter_u)
        f = lambda t: self._fns.nll_raw(self.kernel, t, self._x, self._y,
                                        self._u, jit)
        hv = h.detach().requires_grad_(True)
        with torch.enable_grad():
            v = f(hv)
            g, = torch.autograd.grad(v, hv)
        fd = np.zeros(self._num_hyp)
        for i in range(self._num_hyp):
            e = torch.zeros_like(h)
            e[i] = eps
            fd[i] = (float(f(h + e)) - float(f(h - e))) / (2 * eps)
        return float(v.detach()), _np(g), fd
