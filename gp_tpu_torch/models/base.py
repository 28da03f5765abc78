"""Shared model plumbing (counterpart of gp_tpu/models/base.py):
hyperparameter packing, bounds and the train pipeline.

The GP-level hyperparameter contract of the reference (GP.cpp:85-92,
514-574):

  hyp = [cov hyps ..., log sigma_n, mean]      (length cov.num_hyp + 2)
  sn2  = exp(2 * hyp[-2])                      (GP.cpp:565-569)
  mean = hyp[-1] (raw, not log)                (GP.cpp:570-574)

Noise-free mode removes log sigma_n from the optimization vector
(GP.cpp:535-564) and pins it at -inf.

Units: the fit runs on the standardized targets (y - mu) / sigma with
standardized bounds (an exact reparameterization, see hyp_to_std); the
posterior and every public value are in the original units.
"""

from __future__ import annotations

import os
import sys
from typing import Callable

import numpy as np
import torch

from .. import config
from ..config import (DBL_EPS, DEFAULT_SEED, INF, as_dtype, default_dtype,
                      resolve_device)
from ..ops.kernels import KernelSpec, get_kernel
from ..optim.multistart import GeneratorDraws


# --------------------------------------------------------------------------
# Hyp helpers on tensors
# --------------------------------------------------------------------------

def hyp_sn2(hyp):
    return torch.exp(2.0 * hyp[-2])


def hyp_mean(hyp):
    return hyp[-1]


def to_opt_vec(hyp, noise_free: bool):
    """hyp2vec (GP.cpp:550-564): drop log sigma_n when noise-free."""
    if not noise_free:
        return hyp
    return torch.cat([hyp[:-2], hyp[-1:]])


def from_opt_vec(vec, noise_free: bool):
    """vec2hyp (GP.cpp:535-549): reinsert log sigma_n = -inf when noise-free."""
    if not noise_free:
        return vec
    neg_inf = torch.full((1,), -INF, dtype=vec.dtype, device=vec.device)
    return torch.cat([vec[:-1], neg_inf, vec[-1:]])


def debug_decomp_enabled() -> bool:
    """gp_tpu's switch for the per-evaluation NLL breakdown
    (models/base.py:55-62), the reference's MYDEBUG per-evaluation output
    (GP.cpp:144-146, VFE.cpp:242-245): debug mode (config.DEBUG or
    GP_TPU_DEBUG=1) AND GP_TPU_VERBOSE_OPT=1.  Read on each call."""
    return ((config.DEBUG or os.environ.get("GP_TPU_DEBUG", "0") == "1")
            and os.environ.get("GP_TPU_VERBOSE_OPT", "0") == "1")


def debug_print_nll_decomp(tag: str, **terms):
    """Print one evaluation's NLL terms on stdout as gp_tpu's
    jax.debug.print writes them: "[GP_TPU_DEBUG] tag: key=value ...", each
    value as numpy prints a 0-d array.  Syncs every term to the host, so
    the objectives call it only when debug_decomp_enabled()."""
    body = " ".join(f"{k}={np.asarray(_np(v))}" for k, v in terms.items())
    print(f"[GP_TPU_DEBUG] {tag}: {body}", flush=True)


def sanitize_value_and_grad(f, g):
    """INF-objective semantics (GP.cpp:147-171): non-finite value OR any
    non-finite gradient component turns the evaluation into (+inf, 0)."""
    ok = torch.isfinite(f) & torch.all(torch.isfinite(g))
    f = torch.where(ok, f, torch.full_like(f, INF))
    g = torch.where(ok, g, torch.zeros_like(g))
    return f, g


# --------------------------------------------------------------------------
# Internal y-standardization (float32 conditioning)
# --------------------------------------------------------------------------
#
# hyp_std = [log l (same), log sf - log sigma, log sn - log sigma,
#            (mean - mu)/sigma];   NLL_orig(hyp) = NLL_std(T(hyp)) + N log sigma

def _out_scale(kernel: KernelSpec, nc: int) -> int:
    return (nc + kernel.out_scale_idx if kernel.out_scale_idx < 0
            else kernel.out_scale_idx)


def hyp_to_std(kernel: KernelSpec, nc: int, hyp, mu: float, sigma: float):
    h = np.array(np.asarray(hyp), np.float64)
    ls = np.log(sigma)
    h[_out_scale(kernel, nc)] -= ls
    h[nc] -= ls                      # log sigma_n  (-inf stays -inf)
    h[nc + 1] = (h[nc + 1] - mu) / sigma
    return h


def hyp_from_std(kernel: KernelSpec, nc: int, hyp, mu: float, sigma: float):
    h = np.array(np.asarray(hyp), np.float64)
    ls = np.log(sigma)
    h[_out_scale(kernel, nc)] += ls
    h[nc] += ls
    h[nc + 1] = h[nc + 1] * sigma + mu
    return h


# --------------------------------------------------------------------------
# Host-side hyp defaults / ranges (data-dependent constants)
# --------------------------------------------------------------------------

def default_hyps(kernel: KernelSpec, x, y, noise_lb: float,
                 noise_free: bool) -> np.ndarray:
    """GP::get_default_hyps (GP.cpp:85-92)."""
    x = np.asarray(x)
    y = np.asarray(y).ravel()
    cov = kernel.default_hyp(x, y)
    if noise_free:
        log_sn = -np.inf
    else:
        with np.errstate(divide="ignore"):  # std(y)=0 or noise_lb=0 -> -inf
            log_sn = max(np.log(noise_lb), np.log(np.std(y, ddof=1) * 1e-3))
    return np.concatenate([cov, [log_sn, y.mean()]])


def hyp_range(kernel: KernelSpec, x, y, noise_lb: float):
    """GP::_set_hyp_range (GP.cpp:514-534). Returns (lb, ub) numpy arrays."""
    x = np.asarray(x)
    y = np.asarray(y).ravel()
    nc = kernel.num_hyp(x.shape[1])
    lb = np.full(nc + 2, -np.inf)
    ub = np.full(nc + 2, 0.5 * np.log(0.5 * np.finfo(np.float64).max))
    cov_lb, cov_ub = kernel.hyp_range(x, y)
    lb[:nc], ub[:nc] = cov_lb, cov_ub
    with np.errstate(divide="ignore"):
        lb[nc] = np.log(noise_lb)
        # the reference ties the noise ub to the sigma_f ub (GP.cpp:524-525)
        ub[nc] = max(np.log(10 * noise_lb) if noise_lb > 0 else -np.inf,
                     ub[_out_scale(kernel, nc)])
    lb[nc + 1] = y.min()
    ub[nc + 1] = y.max()
    return lb - DBL_EPS, ub + DBL_EPS


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# --------------------------------------------------------------------------
# Base model class
# --------------------------------------------------------------------------

class GPBase:
    """State + train pipeline (the reference's GP surface, GP.h:79-122).

    `device` defaults to CUDA (raising without one); pass "cpu" to run on
    the CPU.  `dtype` defaults to float64 on the CPU and float32 on CUDA.
    Training is host-orchestrated; every numeric stage runs on `device`.
    Prediction methods return tensors on `device`.
    """

    _MAX_EVAL = 160  # GP.cpp:232

    def __init__(self, train_x, train_y, kernel="se_ard", dtype=None,
                 seed: int = DEFAULT_SEED, solver="chol", device=None):
        x = np.asarray(_np(train_x), dtype=np.float64)
        y = np.asarray(_np(train_y), dtype=np.float64).ravel()
        if x.ndim != 2:
            raise ValueError("train_x must be (num_points, dim)")
        if x.shape[0] != y.shape[0]:
            raise ValueError("train_x and train_y must agree on num_points "
                             f"({x.shape[0]} vs {y.shape[0]})")
        self.kernel = get_kernel(kernel)
        from ..ops.solvers import get_solver
        self.solver = get_solver(solver)
        self._device = resolve_device(device)
        self._dtype = (as_dtype(dtype) if dtype is not None
                       else default_dtype(self._device))
        self._x = self._tensor(x)
        self._y = self._tensor(y)
        self._set_standardization(y)
        self._dim = x.shape[1]
        self._num_cov = self.kernel.num_hyp(self._dim)
        self._num_hyp = self._num_cov + 2
        self._noise_lb = 1e-3        # GP.cpp:28
        self._noise_free = False
        self._fixhyps = False
        self._trained = False
        self._hyps = None
        # the global search's draws (optim/multistart.py): an explicit
        # generator seeded here, as gp_tpu keys its jax.random from seed
        self._seed = int(seed)
        self.draws = GeneratorDraws(seed)
        self.last_search = None      # (best f, evaluations) of the search
        self._post = None            # posterior cache: (*factors, invKys)
        self._post_aux = None        # stream-regime scalars (logdet, nll)
        # a distributed posterior (mesh, block, this process's factor rows,
        # invKys) and one read from a checkpoint, before restore_distributed
        self._post_dist = None
        self._post_dist_pending = None

    def _tensor(self, a):
        """a (numpy, list or tensor) on the model's device and dtype."""
        if isinstance(a, torch.Tensor):
            return a.detach().to(device=self._device, dtype=self._dtype)
        return torch.tensor(np.asarray(a, np.float64), dtype=self._dtype,
                            device=self._device)

    def _set_standardization(self, y_np):
        s = float(np.std(y_np, ddof=1)) if y_np.size > 1 else 0.0
        self._y_mu = float(np.mean(y_np))
        self._y_sigma = s if np.isfinite(s) and s > 0 else 1.0
        self._ys = self._tensor((np.asarray(y_np, np.float64) - self._y_mu)
                                / self._y_sigma)

    def _hyp_to_std(self, hyp):
        return hyp_to_std(self.kernel, self._num_cov, _np(hyp), self._y_mu,
                          self._y_sigma)

    def _hyp_from_std(self, hyp):
        return hyp_from_std(self.kernel, self._num_cov, _np(hyp), self._y_mu,
                            self._y_sigma)

    def _std_bounds(self):
        lb, ub = self.hyp_bounds()
        return self._hyp_to_std(lb), self._hyp_to_std(ub)

    # -- accessors mirroring GP.h:84-101 ------------------------------------
    @property
    def dim(self) -> int:
        return self._dim

    @property
    def num_hyp(self) -> int:
        return self._num_hyp

    @property
    def num_train(self) -> int:
        return int(self._x.shape[0])

    @property
    def trained(self) -> bool:
        return self._trained

    @property
    def noise_free(self) -> bool:
        return self._noise_free

    @property
    def train_in(self):
        return self._x

    @property
    def train_out(self):
        return self._y

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return self._device

    def get_hyp(self):
        return _np(self._hyps)

    def set_fixed(self, flag: bool):
        self._fixhyps = bool(flag)

    def set_noise_free(self, flag: bool):
        """GP.cpp:79-84."""
        self._noise_free = bool(flag)
        if self._noise_free:
            self._noise_lb = 0.0

    def set_noise_lower_bound(self, nlb: float):
        """GP.cpp:63-78."""
        if nlb < 0:
            raise ValueError("noise lower bound must be positive")
        if self._noise_free:
            return  # reference just warns and ignores
        if nlb == 0:
            nlb = DBL_EPS
        self._noise_lb = float(nlb)

    def add_data(self, x, y):
        """Append training points and invalidate training (GP.cpp:43-55)."""
        x = self._tensor(np.asarray(_np(x), np.float64))
        y = self._tensor(np.asarray(_np(y), np.float64).ravel())
        if x.ndim != 2 or x.shape[1] != self._dim:
            raise ValueError("added x must be (num_added, dim)")
        self._x = torch.cat([self._x, x], dim=0)
        self._y = torch.cat([self._y, y], dim=0)
        self._set_standardization(_np(self._y).astype(np.float64))
        self._trained = False

    def get_default_hyps(self) -> np.ndarray:
        return default_hyps(self.kernel, _np(self._x), _np(self._y),
                            self._noise_lb, self._noise_free)

    def hyp_bounds(self):
        return hyp_range(self.kernel, _np(self._x), _np(self._y),
                         self._noise_lb)

    # -- subclass hooks ------------------------------------------------------
    def _nll_value(self, hyp) -> torch.Tensor:
        """Raw scalar NLL (may be NaN/inf) for a full hyp vector."""
        raise NotImplementedError

    def _update_posterior(self):
        """Recompute the posterior cache from self._hyps (the _setK analog).
        May modify self._hyps (noise inflation)."""
        raise NotImplementedError

    def _run_local_opt(self, vec0, lb_v, ub_v):
        raise NotImplementedError

    def _objective_closure(self) -> Callable:
        """fun(vec) -> (f, g) over the optimization vector."""
        raise NotImplementedError

    def _multistart_objective(self) -> Callable:
        """fun(vecs) -> values: the search objective (the NLL with the
        sn2 > mean(sf2) rejection, GP.cpp:470-471) over a batch (c, n) of
        optimization vectors, in the standardized units."""
        raise NotImplementedError

    def _warm_start_hyps(self):
        """Optional model-specific start tried before the noise rescue
        when the initial probe is INF or the defaults were used (None =
        skip).  The exact GP's is the subset MLE, in the stream regime
        only (GP._warm_start_hyps)."""
        return None

    def _nll_from_posterior(self):
        """The final NLL from the cached posterior, or None for a fresh
        nll() evaluation (gp_tpu base.py:331-339).  The exact GP's stream
        regime returns the refined NLL that its posterior computed."""
        return None

    def _final_nll(self) -> float:
        """train()'s return value, on both its exits."""
        v = self._nll_from_posterior()
        return v if v is not None else self.nll(self._hyps)

    # -- shared pipeline (GP.cpp:183-272) ------------------------------------
    def nll(self, hyp=None) -> float:
        """Public NLL evaluation with INF semantics."""
        if hyp is None:
            hyp = self._hyps if self._hyps is not None \
                else self.get_default_hyps()
        v = float(self._nll_value(self._tensor(hyp)))
        return v if np.isfinite(v) else INF

    def select_init_hyp(self, max_eval: int, def_hyp) -> np.ndarray:
        """MVMO global search (GP.cpp:463-485): the adaptive mean-variance
        mapping with archive 25 and the reference's fs 0.5 -> 20 shaping
        schedule (optim.multistart.mvmo_search), over the standardized
        box, with the sn2 > mean(sf2) rejection in the objective.  Draws
        come from `self.draws`.  Returns the best hyps in original units
        (def_hyp when no candidate is finite); `self.last_search` keeps
        (best f in standardized units, objective evaluations)."""
        from ..optim.multistart import mvmo_evaluations, mvmo_search

        nf = self._noise_free
        lb, ub = self._std_bounds()
        x0_v = to_opt_vec(self._tensor(self._hyp_to_std(def_hyp)), nf)
        chunk = self._multistart_chunk()
        best_v, best_f = mvmo_search(
            self._multistart_objective(), self.draws,
            to_opt_vec(self._tensor(lb), nf), to_opt_vec(self._tensor(ub), nf),
            x0_v, num=int(max_eval), chunk=chunk)
        self.last_search = (float(best_f),
                            mvmo_evaluations(int(max_eval), chunk))
        best = from_opt_vec(best_v, nf)
        return self._hyp_from_std(_np(best).astype(np.float64))

    def _multistart_chunk(self) -> int:
        """Candidates per objective call of the search: gp_tpu's bound on
        peak memory (each candidate factors an (n x n) matrix).  The chunk
        changes memory only, never a value."""
        n = self.num_train
        budget = 2 * 10**8 / max(n * n, 1)
        return max(1, min(32, int(budget)))

    def train_multistart(self, n_starts: int = 8, init_hyps=None) -> float:
        """Multi-start MLE: n_starts bounded L-BFGS runs, the clipped start
        (the one train() takes) and n_starts - 1 uniform ones from
        `self.draws` (optim.multistart.multistart_lbfgsb); keeps the best
        finite optimum.  gp_tpu vmaps the starts into one program; here
        they run one after another, with the same values.
        `self.last_multistart` keeps the MultistartResult (standardized
        units)."""
        from ..optim.multistart import multistart_lbfgsb

        if init_hyps is None:
            init_hyps = self.get_default_hyps()
        hyps = np.array(_np(init_hyps), np.float64)
        nf = self._noise_free
        if nf:
            hyps[-2] = -np.inf
        lb, ub = self._std_bounds()
        lb_v = to_opt_vec(self._tensor(lb), nf)
        ub_v = to_opt_vec(self._tensor(ub), nf)
        vec0 = torch.clamp(to_opt_vec(self._tensor(self._hyp_to_std(hyps)),
                                      nf), lb_v, ub_v)
        res = multistart_lbfgsb(self._objective_closure(), self.draws, lb_v,
                                ub_v, vec0, n_starts=n_starts,
                                max_evals=self._MAX_EVAL)
        self.last_multistart = res
        self._hyps = self._tensor(self._hyp_from_std(
            _np(from_opt_vec(res.x, nf)).astype(np.float64)))
        self._update_posterior()
        self._trained = True
        return self.nll(self._hyps)

    def train(self, init_hyps=None) -> float:
        """MLE fit; returns the final NLL (GP::train contract).  In an exact
        GP's stream regime that is the posterior's refined NLL
        (_nll_from_posterior), first order in the factor's error: below
        the float32 conditioning floor it is not accurate, and
        set_k_streamed warns (models/exact.py)."""
        used_defaults = init_hyps is None
        if init_hyps is None:
            init_hyps = self.get_default_hyps()
        hyps = np.array(_np(init_hyps), np.float64)
        if self._noise_free:
            hyps[-2] = -np.inf

        # gp_tpu's train-start gradient check under GP_TPU_DEBUG
        # (gp_tpu/models/base.py:405-418, the reference's MYDEBUG build)
        if config.DEBUG or os.environ.get("GP_TPU_DEBUG", "0") == "1":
            g, fd, rel = self.check_gradients(hyps)
            print(f"[GP_TPU_DEBUG] train-start gradient check: "
                  f"rel_err={rel:.3e}", file=sys.stderr)
            if not np.isfinite(rel) or rel > 1e-2:
                print(f"[GP_TPU_DEBUG]   analytic={g}\n"
                      f"[GP_TPU_DEBUG]   numeric ={fd}", file=sys.stderr)

        nlz = self.nll(hyps)
        if not np.isfinite(nlz) or used_defaults:
            warm = self._warm_start_hyps()
            if warm is not None:
                v = self.nll(warm)
                if np.isfinite(v) and (not np.isfinite(nlz) or v < nlz):
                    hyps, nlz = np.asarray(warm, np.float64), v
        if not np.isfinite(nlz) and not self._noise_free:
            # START-POINT noise rescue: inflate log_sn by log sqrt(10)
            # steps (the _setK recovery schedule, GP.cpp:431-440) before
            # discarding the start: in f32 a small-noise start can be
            # non-SPD purely numerically
            trial = hyps.copy()
            for _ in range(16):
                trial[-2] = (np.log(DBL_EPS) if np.isinf(trial[-2])
                             else trial[-2] + 0.5 * np.log(10.0))
                v = self.nll(trial)
                if np.isfinite(v):
                    hyps, nlz = trial, v
                    break
        if not np.isfinite(nlz):
            hyps = self.select_init_hyp(self._num_hyp * 50, hyps)

        self._hyps = self._tensor(hyps)
        if self._fixhyps:
            self._update_posterior()
            self._trained = True
            return self._final_nll()

        # optimize in the standardized space; the optimizer state stays in
        # the model dtype (an f64-state / f32-objective mix lets the line
        # search accept steps at the f32 noise floor)
        hyps_std = self._hyp_to_std(hyps)
        lb, ub = self._std_bounds()
        nf = self._noise_free
        lb_v = to_opt_vec(torch.from_numpy(lb), nf).numpy()
        ub_v = to_opt_vec(torch.from_numpy(ub), nf).numpy()
        vec0 = np.clip(to_opt_vec(torch.from_numpy(hyps_std), nf).numpy(),
                       lb_v, ub_v)

        res = self._run_local_opt(self._tensor(vec0), self._tensor(lb_v),
                                  self._tensor(ub_v))
        # diagnostics (explain_result): f in ORIGINAL units
        self.last_opt_result = res._replace(
            f=res.f + self.num_train * float(np.log(self._y_sigma)))
        self._hyps = self._tensor(self._hyp_from_std(
            _np(from_opt_vec(res.x, nf)).astype(np.float64)))

        self._update_posterior()
        self._trained = True
        return self._final_nll()

    def check_gradients(self, hyp=None, eps: float = 1e-3):
        """Analytic-vs-finite-difference NLL gradient check
        (GP::_likelihood_gradient_checking, GP.cpp:486-507).  Returns
        (analytic, numeric, rel_err) as numpy arrays / float."""
        if hyp is None:
            hyp = self._hyps if self._hyps is not None else \
                self.get_default_hyps()
        hyp = np.asarray(_np(hyp), np.float64)

        fun = self._objective_closure()
        v = self._tensor(to_opt_vec(torch.from_numpy(self._hyp_to_std(hyp)),
                                    self._noise_free))
        _, g = fun(v)
        g = _np(g).astype(np.float64)

        fd = np.zeros_like(g)
        for i in range(g.shape[0]):
            e = torch.zeros_like(v)
            e[i] = eps
            fp, _ = fun(v + e)
            fm, _ = fun(v - e)
            fd[i] = (float(fp) - float(fm)) / (2 * eps)
        denom = np.linalg.norm(fd) + 1e-300
        rel = float(np.linalg.norm(g - fd) / denom)
        return g, fd, rel

    # -- checkpoint / resume (gp_tpu base.py:577-590) ------------------------
    def save(self, path: str) -> None:
        """Write the model and its posterior cache to an .npz checkpoint in
        gp_tpu's format (utils/checkpoint.py)."""
        from ..utils.checkpoint import save_model
        save_model(self, path)

    @staticmethod
    def load(path: str, device=None):
        """A model from a checkpoint of either package, its posterior cache
        intact (no refactorization); on CUDA unless device says
        otherwise."""
        from ..utils.checkpoint import load_model
        return load_model(path, device)

    # -- shared prediction surface (GP.h:104-119) ----------------------------
    def _require_trained(self):
        if not self._trained:
            raise RuntimeError("model is not trained; call train() first")
        if (self._post is None and self._post_dist is None
                and self._post_dist_pending is not None):
            raise RuntimeError(
                "checkpoint carries a distributed posterior; call "
                "restore_distributed(mesh) before serving")

    def _as_batch(self, xs):
        xs = self._tensor(xs)
        if xs.ndim == 1:
            xs = xs[None, :]
        if xs.shape[1] != self._dim:
            raise ValueError(f"test points must have dim {self._dim}")
        return xs

    def predict_y(self, xs) -> float:
        return float(self.batch_predict_y(xs)[0])

    def predict_s2(self, xs) -> float:
        return float(self.batch_predict_s2(xs)[0])

    def predict(self, xs):
        y, s2 = self.batch_predict(xs)
        return float(y[0]), float(s2[0])

    def predict_y_with_grad(self, xs):
        y, g = self.batch_predict_y_with_grad(xs)
        return float(y[0]), g[0]

    def predict_s2_with_grad(self, xs):
        s2, g = self.batch_predict_s2_with_grad(xs)
        return float(s2[0]), g[0]

    def predict_with_grad(self, xs):
        y, gy = self.predict_y_with_grad(xs)
        s2, gs2 = self.predict_s2_with_grad(xs)
        return y, s2, gy, gs2
