"""The exact Gaussian process, SE-ARD: one model family, found by the
name that a configuration gives under "family" (configs/<config>.json).

A family holds the three things in the benchmark that depend on the
model:

  the program side  model(kind, X, y, config, dtype, device): the port's
                    model for a traffic kind, built through gp_tpu_torch's
                    public entry points with the configuration's kernel
                    (program.Port then drives its GP surface);
  the reference     Reference(config): the plain float64 PyTorch
                    functions that judge.py, control.py and fit_hyps.py
                    call, in signatures that carry what a family needs
                    (a sparse family takes its inducing set from config);
  the counts        fit_eval_flops(config), predict_request_flops(config,
                    rows): the model operations of one objective
                    evaluation and of one request, which the MFU readers
                    divide by.

KERNELS are the kernels the reference computes, KINDS the traffic kinds
(loops.KINDS) the family serves: harness.family refuses a cell outside
them before set-up.  The module imports nothing of the program: the
program side imports gp_tpu_torch when it builds a model, and the
reference and the counts are benchmark files (reference/gp.py,
roofline.py), so that the yardstick cannot move with the program.

Here: GP for fit and predict, BucketedGP(bucket=config["bucket"]) for
bo, the Cholesky solver; the reference is reference/gp.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpbench import roofline
from gpbench.reference import gp

KERNELS = ("se_ard",)
KINDS = ("fit", "predict", "bo")

# gp_tpu's stream threshold: from this many rows the posterior caches no
# factor, and every variance request refactors K
STREAM_MIN_N = 32768


def model(kind: str, X, y, config: dict, dtype, device):
    """The port's model of the rows (X, y) for a `kind` cell."""
    if kind == "bo":
        from gp_tpu_torch import BucketedGP
        return BucketedGP(X, y, bucket=config["bucket"],
                          kernel=config["kernel"], dtype=dtype,
                          device=device)
    from gp_tpu_torch import GP
    return GP(X, y, kernel=config["kernel"], dtype=dtype, device=device)


class Posterior(NamedTuple):
    x: torch.Tensor
    hyp: torch.Tensor  # as factored: the noise raised where the factor failed
    L: torch.Tensor
    alpha: torch.Tensor


class Reference:
    """reference/gp.py for one configuration.  `prec` is "float64", or
    "tf32" for the control; a hyperparameter vector is the library's, and
    v the optimizer's point in the units of standardized(y)."""

    nll = staticmethod(gp.nll)                  # (x, y, hyp, prec)
    nll_grad = staticmethod(gp.nll_grad)        # (x, ys, v, prec)
    default_hyp = staticmethod(gp.default_hyp)  # (x, y)
    hyp_bounds = staticmethod(gp.hyp_bounds)    # (x, y)
    standardized = staticmethod(gp.standardized)
    to_standardized = staticmethod(gp.to_standardized)
    from_standardized = staticmethod(gp.from_standardized)
    projected_gradient = staticmethod(gp.projected_gradient)

    def __init__(self, config: dict):
        """The exact family reads nothing of `config`."""

    def posterior(self, x, y, hyp, prec: str) -> Posterior:
        return Posterior(x, *gp.posterior(x, y, hyp, prec))

    def predict(self, post: Posterior, xs, prec: str):
        """(mu, s2) at the rows xs."""
        return gp.predict(post.x, post.hyp, post.L, post.alpha, xs, prec)

    def predict_with_grad(self, post: Posterior, xs, prec: str):
        """(mu, dmu/dxs, s2, ds2/dxs) at the rows xs."""
        return gp.predict_with_grad(post.x, post.hyp, post.L, post.alpha,
                                    xs, prec)


def fit_eval_flops(config: dict) -> float:
    return roofline.fit_eval_flops(config["n"], config["d"])


def predict_request_flops(config: dict, rows: int) -> float:
    """A request's work; its factorization only where the posterior
    caches none (N >= STREAM_MIN_N)."""
    n = config["n"]
    return roofline.predict_request_flops(n, config["d"], rows,
                                          refactors=n >= STREAM_MIN_N)
