"""BucketedGP: the exact GP of a Bayesian-optimisation loop, which adds one
observation at a time (counterpart of gp_tpu/models/bucketed.py;
reference: GP::add_data, GP.cpp:43-55).

gp_tpu keeps the data in a buffer of fixed capacity (a multiple of
`bucket`) and passes the live row count to its programs as a traced
scalar, so that add_data and train re-run the same compiled program until
the buffer grows.  The port has no trace to keep, so the padding of the
objective, set_k and the predictions went: _x, _y and _ys are views of
the buffers' first num_train rows.  The NLL, the objective and the fit
are the masked family's (models/exact.py), which compute on those rows;
GP's predictions run on them unchanged (through _factors() and
_inv_kys(), here views of the factor buffer's live block).  On real rows
gp_tpu's identity-masked pad gives the same NLL, gradient and posterior,
up to rounding.  What stays are the rules that decide the values:

  * capacity = ceil(n / bucket) * bucket; add_data within capacity keeps
    the y-standardization (_y_mu, _y_sigma) frozen and standardizes the
    new rows with it; past capacity it recomputes them and the capacity
    grows to the next bucket multiple;
  * absorb appends one point to the Cholesky factor in O(capacity^2) with
    the hyperparameters kept, and refactorizes when it cannot
    (exact.append_posterior_masked);
  * the objective takes alpha by the factor, and every stage runs the
    dense masked programs at any N (gp_tpu overrides each of GP's stages,
    bucketed.py:130-233).  From _STREAM_MIN_N rows only the subset-MLE
    warm start of GP's stream regime applies (gp_tpu's _in_stream_regime
    keys it, and is true for a Cholesky BucketedGP); the fit, the
    posterior (set_k_masked's sqrt(10) rescue), absorb, the predictions
    and train()'s returned NLL (the masked NLL) stay the masked family's.

The posterior factor keeps gp_tpu's layout: a (capacity x capacity)
buffer blockdiag(L, I), so that absorb writes one row in place instead
of reallocating the factor (256 MB per observation at N = 8000 in f32),
and so that a checkpoint's factor is gp_tpu's.

One difference from gp_tpu, from N >= _STREAM_MIN_N rows: gp_tpu's
batch_predict, batch_predict_s2 and both *_with_grad raise there
(GP._factors asserts that a stream-regime posterior caches no factor,
and BucketedGP inherits the assertion although its posterior does cache
one); the port returns the values of gp_tpu's predict_masked and
_predict_single_masked on the cached factor.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import _np
from .exact import (GP, _inf_where_nonfinite, append_posterior_masked,
                    fit_masked, multistart_objective_masked, nll_raw_masked,
                    objective_vg_masked, set_k_masked)


def _pad_rows(a, cap: int):
    out = a.new_zeros((cap,) + tuple(a.shape[1:]))
    out[:a.shape[0]] = a
    return out


class BucketedGP(GP):
    """Exact GP over buffers of a fixed capacity; `bucket` is the growth
    granule.  Runs on CUDA unless given device="cpu", as GP."""

    def __init__(self, train_x, train_y, bucket: int = 64, **kw):
        super().__init__(train_x, train_y, **kw)
        self._bucket = int(bucket)
        self._refresh_buffers()

    # -- buffer management ---------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self._xp.shape[0])

    def _live(self, n: int):
        """_x, _y and _ys as views of the buffers' first n rows."""
        self._x, self._y, self._ys = self._xp[:n], self._yp[:n], \
            self._ysp[:n]

    def _refresh_buffers(self):
        n = self.num_train
        cap = -(-n // self._bucket) * self._bucket
        self._xp = _pad_rows(self._x, cap)
        self._yp = _pad_rows(self._y, cap)
        self._ysp = _pad_rows(self._ys, cap)
        self._live(n)

    def add_data(self, x, y):
        """Append points.  Within capacity the rows are written in place and
        the y-standardization stays frozen (gp_tpu freezes it so that no
        program input changes); past capacity it is recomputed and the
        buffers grow to the next multiple of `bucket`."""
        x = self._tensor(np.asarray(_np(x), np.float64))
        y = self._tensor(np.asarray(_np(y), np.float64).ravel())
        if x.ndim != 2 or x.shape[1] != self._dim:
            raise ValueError("added x must be (num_added, dim)")
        n0, n1 = self.num_train, self.num_train + x.shape[0]
        self._trained = False
        if n1 > self.capacity:
            self._x = torch.cat([self._x, x])
            self._y = torch.cat([self._y, y])
            self._set_standardization(_np(self._y).astype(np.float64))
            self._refresh_buffers()
            return
        self._xp[n0:n1] = x
        self._yp[n0:n1] = y
        self._ysp[n0:n1] = (y - self._y_mu) / self._y_sigma
        self._live(n1)

    def absorb(self, x, y):
        """Add ONE point and update the posterior in O(capacity^2) without
        refitting (hyperparameters kept): the BO serving path.  Needs a
        trained model with the Cholesky solver and room in the buffer;
        otherwise add_data and _update_posterior (an O(capacity^3)
        refactorization, the same route when the appended pivot is not
        positive)."""
        x = np.asarray(_np(x), np.float64).reshape(-1)
        y = float(np.asarray(_np(y)).reshape(()))
        if x.shape[0] != self._dim:
            raise ValueError(f"absorb expects a single point of dim "
                             f"{self._dim}")
        cheap = (self._trained and self.solver.name == "chol"
                 and self.num_train + 1 <= self.capacity)
        if not cheap:
            self.add_data(x[None, :], [y])
            if self._hyps is not None:
                self._update_posterior()
                self._trained = True
            return
        n0 = self.num_train
        xd, yd = self._tensor(x), self._tensor(y)
        _, _, L, invKys, ok = append_posterior_masked(
            self.kernel, self._hyps, self._xp, self._yp, n0, self._post[0],
            xd, yd)
        self._ysp[n0] = (yd - self._y_mu) / self._y_sigma
        self._live(n0 + 1)
        if bool(ok):
            self._post = (L, invKys)
        else:   # non-positive pivot: the full rescue path
            self._update_posterior()

    # -- the masked family's stages (gp_tpu bucketed.py:130-198) -----------
    def _factor_free(self) -> bool:
        return False

    def _nll_value(self, hyp):
        return _inf_where_nonfinite(nll_raw_masked(
            self.kernel, hyp, self._xp, self._yp, self.num_train,
            self.solver))

    def _objective_closure(self):
        kernel, noise_free, solver = self.kernel, self._noise_free, \
            self.solver
        xp, ysp, n = self._xp, self._ysp, self.num_train
        return lambda v: objective_vg_masked(kernel, noise_free, v, xp, ysp,
                                             n, solver)

    def _multistart_objective(self):
        kernel, noise_free, solver = self.kernel, self._noise_free, \
            self.solver
        xp, ysp, n = self._xp, self._ysp, self.num_train
        return lambda vecs: torch.stack([multistart_objective_masked(
            kernel, noise_free, v, xp, ysp, n, solver) for v in vecs])

    def _run_local_opt(self, vec0, lb_v, ub_v):
        return fit_masked(self.kernel, self._noise_free, self._xp,
                          self._ysp, self.num_train, vec0, lb_v, ub_v,
                          max_evals=self._MAX_EVAL, solver=self.solver)

    def _update_posterior(self):
        hyp, f, invKys, ok = set_k_masked(self.kernel, self._hyps, self._xp,
                                          self._yp, self.num_train,
                                          self.solver)
        if not ok:
            # reference parity (GP.cpp:423-444): never serve a failed factor
            raise RuntimeError(
                "posterior factorization failed after noise inflation "
                "(set_k_masked exhausted max_tries); refusing to cache a "
                "NaN posterior")
        self._hyps = hyp
        self._post = (*f, invKys)

    # -- GP's predictions over the live block of the posterior ------------
    def _factors(self):
        n = self.num_train
        return tuple(a[:n] if a.ndim == 1 else a[:n, :n]
                     for a in self._post[:-1])

    def _inv_kys(self):
        return self._post[-1][:self.num_train]
