"""FITC, the upstream library's sparse GP (FITC.cpp), SE-ARD: one model
family, found by the name that a configuration gives under "family"
(families/exact.py says what a family holds).

  the rows          the configuration's "rows": make_data's rows mixed by
                    a fixed linear map (`rows`), on both sides of the
                    comparison: the program's model is fitted to them and
                    predicts at them, and the reference computes on them;
  the program side  model("fit", ...): gp_tpu_torch's FITC of the rows,
                    with set_inducing of the configuration's inducing rows
                    (the last m, as the upstream's `fitc N M` demo takes
                    train_x.rightCols(M)); program.Port then runs train()
                    and batch_predict;
  the reference     reference/fitc.py in float64, with the library's start,
                    box and standardized units of reference/gp.py (FITC
                    keeps GP's: GP.cpp:85-92, 514-534);
  the counts        fit_eval_flops(config), one NLL + gradient evaluation,
                    which fit_mfu divides by.

A fit cell only: the family serves no fixed-hyperparameter traffic.

Why the rows are mixed.  The traffic's loop draws gpbench/synth.make_data
rows: independent inputs, uniform in [-2, 2].  At d = 90 the library's
start (log l_k = log std(x_k)) puts every pair of such rows ~e^-90 apart
in covariance, so the start is a stationary point: a fit never leaves it
and predicts the mean, and a fault in the optimizer cannot show.  Inputs
such as Song's (12 timbre averages, 78 timbre covariances) are
correlated: a few directions carry most of their spread.  `rows` gives
make_data's rows that shape, X diag(s) Q, with s = 1 on the `signal`
inputs that make_data's targets depend on and `weak` on the others, and
Q a fixed rotation drawn from `seed`; the map is invertible, so the
targets stay a smooth function of the mapped rows.  It is applied here
because the loop draws the rows by make_data alone.
"""

from __future__ import annotations

import numpy as np
import torch

from gpbench import roofline
from gpbench.reference import fitc
from gpbench.reference import gp

KERNELS = ("se_ard",)
KINDS = ("fit",)

# the dtype the reference computes in, by the precision the judge or the
# control asks for.  The control's "tf32" stands for the step below the
# configuration's precision (control.py); below this family's float64
# that step is float32, with plain products
_DTYPE = {"float64": torch.float64, "tf32": torch.float32}


def _last_m(config: dict) -> int:
    if config.get("inducing") != "last":
        raise ValueError(f"fitc family: inducing {config.get('inducing')!r}; "
                         f"it takes the last m rows (\"last\")")
    return int(config["m"])


def mixing(config: dict) -> np.ndarray:
    """The (d, d) map of the configuration's "rows": diag(s) Q, s = 1 on
    the first `signal` inputs and `weak` on the rest, Q the orthogonal
    factor of a standard normal matrix drawn from `seed` (its columns'
    signs fixed by R's diagonal)."""
    r, d = config["rows"], config["d"]
    G = np.random.default_rng(r["seed"]).standard_normal((d, d))
    Q, R = np.linalg.qr(G)
    Q = Q * np.sign(np.diag(R))
    s = np.full(d, float(r["weak"]))
    s[:r["signal"]] = 1.0
    return s[:, None] * Q


def rows(X, config: dict) -> np.ndarray:
    """make_data's rows X (numpy or a tensor) as the configuration states
    them: X diag(s) Q, in float64 on the host."""
    if isinstance(X, torch.Tensor):
        X = X.detach().to("cpu", torch.float64).numpy()
    return np.asarray(X, np.float64) @ mixing(config)


class Model:
    """gp_tpu_torch's FITC of the mapped rows, with what program.Port
    calls of it: train(), batch_predict of make_data rows (mapped here),
    get_hyp(), last_opt_result and the evaluation cap _MAX_EVAL."""

    def __init__(self, fitc_model, config: dict):
        self.gp, self.config = fitc_model, config

    @property
    def _MAX_EVAL(self):
        return self.gp._MAX_EVAL

    @_MAX_EVAL.setter
    def _MAX_EVAL(self, v):
        self.gp._MAX_EVAL = v

    def train(self, init_hyps=None) -> float:
        return self.gp.train(init_hyps)

    def batch_predict(self, xs):
        return self.gp.batch_predict(rows(xs, self.config))

    def get_hyp(self):
        return self.gp.get_hyp()

    @property
    def last_opt_result(self):
        return self.gp.last_opt_result


def model(kind: str, X, y, config: dict, dtype, device) -> Model:
    """gp_tpu_torch's FITC of (rows(X), y), its inducing set the last m
    rows."""
    from gp_tpu_torch import FITC
    x = rows(X, config)
    gp_ = FITC(x, y, kernel=config["kernel"], dtype=dtype, device=device)
    gp_.set_inducing(x[-_last_m(config):])
    return Model(gp_, config)


class Reference:
    """reference/fitc.py for one configuration, on the rows as the
    configuration states them (`rows` of the make_data rows it is given).
    `prec` is "float64", or "tf32" for the control (float32 here); a
    hyperparameter vector is the library's, and v the optimizer's point in
    the units of standardized(y)."""

    to_standardized = staticmethod(gp.to_standardized)
    from_standardized = staticmethod(gp.from_standardized)
    projected_gradient = staticmethod(gp.projected_gradient)

    def __init__(self, config: dict):
        self.config = config
        self.m = _last_m(config)

    def _rows(self, x, dtype=None):
        return torch.as_tensor(rows(x, self.config), device=x.device,
                               dtype=dtype or x.dtype)

    def default_hyp(self, x, y):
        return gp.default_hyp(self._rows(x), y)

    def hyp_bounds(self, x, y):
        return gp.hyp_bounds(self._rows(x), y)

    @staticmethod
    def standardized(y):
        """gp.standardized; the targets carry std(y) as `.y_sigma`, the
        scale in whose square nll_grad takes the library's jitter."""
        ys, mu, sigma = gp.standardized(y)
        ys.y_sigma = sigma
        return ys, mu, sigma

    def nll(self, x, y, hyp, prec: str) -> float:
        """train()'s value at hyp (reference/fitc.py train_nll): the NLL
        at the jitter that the final posterior settles on."""
        dt = _DTYPE[prec]
        x = self._rows(x, dt)
        return fitc.train_nll(x, y.to(dt), hyp.to(dt),
                              fitc.inducing(x, self.m))

    def nll_grad(self, x, ys, v, prec: str):
        """At v in the units of the targets ys that standardized()
        returned, where the library's jitter is JITTER / std(y)^2
        (models/sparse.py's _jitter_std)."""
        dt = _DTYPE[prec]
        x = self._rows(x, dt)
        return fitc.nll_grad(x, ys.to(dt), v.to(dt),
                             fitc.inducing(x, self.m),
                             fitc.JITTER / ys.y_sigma ** 2)

    def posterior(self, x, y, hyp, prec: str) -> fitc.Posterior:
        dt = _DTYPE[prec]
        x = self._rows(x, dt)
        return fitc.posterior(x, y.to(dt), hyp.to(dt),
                              fitc.inducing(x, self.m))

    def predict(self, post: fitc.Posterior, xs, prec: str):
        """(mu, s2) at the make_data rows xs."""
        return fitc.predict(post, self._rows(xs, _DTYPE[prec]))


def fit_eval_flops(config: dict) -> float:
    """Model operations of one FITC NLL + gradient evaluation (the
    objective of models/fitc.py, autograd's backward), N rows, M inducing
    rows, d inputs:

      forward   Kxu, Kuu builds (2 d cross term and the SE map per entry,
                as roofline.fit_eval_flops counts K)   (2d + 3 + map)(NM + M^2)
                the two M x M Cholesky factors         2 M^3 / 3
                V = Luu^-1 Kux, a triangular solve     N M^2
                qdiag, Gamma, Kux Gamma^-1             3 N M
                the weighted Gram Kux Gamma^-1 Kxu     2 N M^2
                Kux Gamma^-1 r, A^-1 of it, Kxu of it  4 N M + 2 M^2
      backward  the Gram's two operand products        4 N M^2
                the solve's: L^-T of the cotangent,
                and its product with V^T               3 N M^2
                the builds' closed-form VJP: G o K,
                row and column sums, E b               (2d + 3)(NM + M^2)
                the two factors'                       2 M^3

    10 N M^2 of it dominate.  Counted at N and M, as the work these
    shapes need."""
    n, m, d = config["n"], config["m"], config["d"]
    entry = 3 + roofline.MAP_OPS["se"]
    build = (2 * d + entry) * (n * m + m * m)
    forward = (build + 2 * m ** 3 / 3 + n * m ** 2 + 3 * n * m
               + 2 * n * m ** 2 + 4 * n * m + 2 * m ** 2)
    backward = (4 * n * m ** 2 + 3 * n * m ** 2
                + (2 * d + 3) * (n * m + m * m) + 2 * m ** 3)
    return float(forward + backward)
