"""BucketedGP: the exact GP of a Bayesian-optimisation loop, which adds one
observation at a time (counterpart of gp_tpu/models/bucketed.py;
reference: GP::add_data, GP.cpp:43-55).

gp_tpu keeps the data in a buffer of fixed capacity (a multiple of
`bucket`) and passes the live row count to its programs as a traced
scalar, so that add_data and train re-run the same compiled program until
the buffer grows.  The port has no trace to keep, so the padding of the
objective, set_k and the predictions went: _x, _y and _ys are views of
the buffers' first num_train rows, and GP's objective, fit and
predictions run on them unchanged (the predictions through _factors()
and _inv_kys(), here views of the factor buffer's live block).  On real
rows gp_tpu's identity-masked pad gives the same NLL, gradient and
posterior, up to rounding.  The objective prints no NLL breakdown, as
gp_tpu's masked family does not.  What stays are the rules that decide
the values:

  * capacity = ceil(n / bucket) * bucket; add_data within capacity keeps
    the y-standardization (_y_mu, _y_sigma) frozen and standardizes the
    new rows with it; past capacity it recomputes them and the capacity
    grows to the next bucket multiple;
  * absorb appends one point to the Cholesky factor in O(capacity^2) with
    the hyperparameters kept, and refactorizes when it cannot
    (exact.append_posterior_masked).

The posterior factor keeps gp_tpu's layout: a (capacity x capacity)
buffer blockdiag(L, I), so that absorb writes one row in place instead
of reallocating the factor (256 MB per observation at N = 8000 in f32),
and so that a checkpoint's factor is gp_tpu's.

Not carried: BucketedGP in the stream regime (N >= 32768).  Its absorb
appends to the N^2 factor that the stream regime never keeps, and
gp_tpu's masked family has no stream form (it runs its dense programs
at any N), so a BucketedGP of that size raises; GP serves that N.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import _np
from . import exact
from .exact import GP, append_posterior_masked, set_k_masked


def _check_n(n: int) -> None:
    if n >= exact._STREAM_MIN_N:
        raise NotImplementedError(
            f"BucketedGP at N={n} >= {exact._STREAM_MIN_N} rows is not "
            f"carried (its absorb needs the N^2 factor that the stream "
            f"regime does not keep); use GP")


def _pad_rows(a, cap: int):
    out = a.new_zeros((cap,) + tuple(a.shape[1:]))
    out[:a.shape[0]] = a
    return out


class BucketedGP(GP):
    """Exact GP over buffers of a fixed capacity; `bucket` is the growth
    granule.  Runs on CUDA unless given device="cpu", as GP."""

    _DECOMP = False

    def __init__(self, train_x, train_y, bucket: int = 64, **kw):
        super().__init__(train_x, train_y, **kw)
        _check_n(self.num_train)
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
        _check_n(n1)
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
