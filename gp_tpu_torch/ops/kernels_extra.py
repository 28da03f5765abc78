"""Additional stationary covariance families (counterpart of
gp_tpu/ops/kernels_extra.py).

The same KernelSpec contract as the SE family, with gp_tpu's hyp packing
([log lengthscales..., log sigma_f (+ extras)]) and span-derived
lengthscale boxes:

  matern52[_iso]   k = sf^2 (1 + a r + a^2 r^2 / 3) exp(-a r),  a = sqrt(5)
  matern32[_iso]   k = sf^2 (1 + a r) exp(-a r),                a = sqrt(3)
  rq[_iso]         k = sf^2 (1 + d^2 / (2 alpha)) ^ (-alpha)
                   (scaled distances; extra hyp: log alpha, appended last)

`k` and `k_noise` are the kernel-backed autograd Functions of
ops/se_tile.py in the forms "m52", "m32" and "rq", as gp_tpu makes its
fused Pallas builds the default for these specs: on CUDA every build is
the hand-written tile kernel, on the CPU its plain version.  None of them
has a structured gradient contraction, so the exact-GP objective takes the
vjp of k_noise at Q = K^-1 - alpha alpha^T (models/exact.nll_vg_raw).

`_matern_k`, `_rq_k_ard` and `_rq_k_iso` are the plain formulas, kept as
the reference the closed-form backwards are tested against.  r = sqrt(d^2)
is not differentiable at r = 0, so Matern takes a floored sqrt: the true
derivative at coincident points is 0, and the floor keeps it finite.

Importing this module adds the six specs to ops.kernels.KERNELS; the
package imports it.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import (KERNELS, KernelSpec, _seard_default_hyp,
                      _seard_diag_k, _seard_hyp_range, _seiso_default_hyp,
                      _seiso_diag_k, _seiso_hyp_range)
from .sdist import sqdist
from .se_tile import R_FLOOR, cov_k, cov_k_noise


def _scaled_d2(inv_l, x1, x2):
    return sqdist(x1 * inv_l, x2 * inv_l)


def _matern_k(nu_c: float):
    """Plain Matern k_from(inv_l, sf2, x1, x2); nu_c = sqrt(3) (Matern-3/2)
    or sqrt(5) (Matern-5/2)."""
    five_half = abs(nu_c ** 2 - 5.0) < 1e-12
    # a Python float: a float64 tensor constant would promote a float32
    # covariance to float64 (gp_tpu kernels_extra.py:43-47)
    nu_c = float(nu_c)

    def k_from(inv_l, sf2, x1, x2):
        ar = nu_c * torch.sqrt(_scaled_d2(inv_l, x1, x2) + R_FLOOR)
        poly = 1.0 + ar
        if five_half:
            poly = poly + ar * ar / 3.0
        return sf2 * poly * torch.exp(-ar)

    return k_from


def _ard(k_from):
    def k(chyp, x1, x2):
        d = x1.shape[-1]
        return k_from(torch.exp(-chyp[:d]), torch.exp(2.0 * chyp[d]), x1, x2)
    return k


def _iso(k_from):
    def k(chyp, x1, x2):
        return k_from(torch.exp(-chyp[0]), torch.exp(2.0 * chyp[1]), x1, x2)
    return k


def _make_stationary(name: str, form: str):
    ard = KernelSpec(
        name=name,
        num_hyp=lambda dim: dim + 1,
        k=cov_k(form, True),
        diag_k=_seard_diag_k,
        default_hyp=_seard_default_hyp,
        hyp_range=_seard_hyp_range,
        k_noise=cov_k_noise(form, True),
    )
    iso = KernelSpec(
        name=f"{name}_iso",
        num_hyp=lambda dim: 2,
        k=cov_k(form, False),
        diag_k=_seiso_diag_k,
        default_hyp=_seiso_default_hyp,
        hyp_range=_seiso_hyp_range,
        k_noise=cov_k_noise(form, False),
    )
    return ard, iso


MATERN52, MATERN52_ISO = _make_stationary("matern52", "m52")
MATERN32, MATERN32_ISO = _make_stationary("matern32", "m32")


# -- Rational Quadratic: extra log-alpha hyp appended after log sigma_f ----

def _rq_k_ard(chyp, x1, x2):
    """Plain RQ-ARD formula, chyp = [log l_1..d, log sf, log alpha]."""
    d = x1.shape[-1]
    inv_l = torch.exp(-chyp[:d])
    sf2 = torch.exp(2.0 * chyp[d])
    alpha = torch.exp(chyp[d + 1])
    d2 = _scaled_d2(inv_l, x1, x2)
    return sf2 * torch.pow(1.0 + d2 / (2.0 * alpha), -alpha)


def _rq_k_iso(chyp, x1, x2):
    """Plain RQ-iso formula, chyp = [log l, log sf, log alpha]."""
    inv_l = torch.exp(-chyp[0])
    sf2 = torch.exp(2.0 * chyp[1])
    alpha = torch.exp(chyp[2])
    d2 = _scaled_d2(inv_l, x1, x2)
    return sf2 * torch.pow(1.0 + d2 / (2.0 * alpha), -alpha)


def _rq_default_ard(x, y):
    return np.concatenate([_seard_default_hyp(x, y), [0.0]])   # log alpha=0


def _rq_default_iso(x, y):
    return np.concatenate([_seiso_default_hyp(x, y), [0.0]])


_LOG_ALPHA_BOX = (np.log(1e-3), np.log(1e3))


def _rq_range_ard(x, y):
    lb, ub = _seard_hyp_range(x, y)
    return (np.concatenate([lb, [_LOG_ALPHA_BOX[0]]]),
            np.concatenate([ub, [_LOG_ALPHA_BOX[1]]]))


def _rq_range_iso(x, y):
    lb, ub = _seiso_hyp_range(x, y)
    return (np.concatenate([lb, [_LOG_ALPHA_BOX[0]]]),
            np.concatenate([ub, [_LOG_ALPHA_BOX[1]]]))


RQ = KernelSpec(
    name="rq",
    num_hyp=lambda dim: dim + 2,
    k=cov_k("rq", True),
    diag_k=_seard_diag_k,
    default_hyp=_rq_default_ard,
    hyp_range=_rq_range_ard,
    out_scale_idx=-2,          # log sigma_f sits before log alpha
    k_noise=cov_k_noise("rq", True),
)

RQ_ISO = KernelSpec(
    name="rq_iso",
    num_hyp=lambda dim: 3,
    k=cov_k("rq", False),
    diag_k=_seiso_diag_k,
    default_hyp=_rq_default_iso,
    hyp_range=_rq_range_iso,
    out_scale_idx=-2,
    k_noise=cov_k_noise("rq", False),
)


for spec in (MATERN52, MATERN52_ISO, MATERN32, MATERN32_ISO, RQ, RQ_ISO):
    KERNELS[spec.name] = spec
