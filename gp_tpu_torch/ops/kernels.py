"""Covariance kernels (counterpart of gp_tpu/ops/kernels.py).

Hyperparameter packing is identical to gp_tpu's (and the reference's):

  se_ard: chyp = [log l_1 .. log l_d, log sigma_f]   (CovSEard.cpp:6)
  se_iso: chyp = [log l, log sigma_f]                (CovSEiso.cpp:5)

`k` and `k_noise` of both specs are the kernel-backed autograd Functions
of ops/se_tile.py, as gp_tpu's `_register_pallas_variants` makes its Pallas
builds the default: on CUDA every build is the hand-written tile kernel,
on the CPU its plain version.  Points are rows: x is (n, d).  The
Matern and RQ specs are in ops/kernels_extra.py, which adds them to
KERNELS when the package is imported.

`default_hyp` and `hyp_range` are host-side numpy, computed once per
model from the data.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import DBL_EPS, DBL_MAX, DBL_MIN
from .se_tile import seard_k, seard_k_noise, seiso_k, seiso_k_noise


class KernelSpec(NamedTuple):
    """A covariance function bundle (pure functions, no state)."""
    name: str
    num_hyp: Callable[[int], int]            # dim -> number of cov hyps
    k: Callable                              # (chyp, x1, x2) -> (n1, n2)
    diag_k: Callable                         # (chyp, x) -> (n,)
    default_hyp: Callable                    # (x, y) -> np (num_hyp,)
    hyp_range: Callable                      # (x, y) -> (np lb, np ub)
    # index (into chyp) of the log-output-scale hyp; y-standardization
    # shifts it and log sigma_n by -log s
    out_scale_idx: int = -1
    # (chyp, sn2, x, n_real) -> (n, n): K(X, X) with the diagonal set to
    # diag_k + sn2 on rows < n_real and to diag_k beyond
    k_noise: Callable | None = None
    # (chyp, sn2, x, n_real, K, Kinv, alpha) -> (g_chyp, g_sn2): the
    # k_noise vjp contracted against the implicit cotangent
    # Q = Kinv - alpha alpha^T without materializing Q.  None: the
    # objective materializes Q and takes the vjp of k_noise at Q
    k_noise_vjp_q: Callable | None = None


def _generic_k_noise(spec_k, spec_diag_k):
    """K(X, X) through spec_k, then the diagonal set to diag(K0) + sn2 on
    rows < n_real and to spec_diag_k beyond (gp_tpu kernels.py:66-73)."""
    def k_noise(chyp, sn2, x, n_real: int):
        K0 = spec_k(chyp, x, x)
        ids = torch.arange(x.shape[0], device=x.device)
        dv = torch.where(ids < n_real, torch.diagonal(K0) + sn2,
                         spec_diag_k(chyp, x))
        return torch.diagonal_scatter(K0, dv.to(K0.dtype))
    return k_noise


def get_k_noise(spec: KernelSpec) -> Callable:
    """spec.k_noise, or the generic build + diagonal scatter for a spec
    without a fused build (every spec of the package has one)."""
    if spec.k_noise is not None:
        return spec.k_noise
    return _generic_k_noise(spec.k, spec.diag_k)


def _se_noise_vjp_q(ard: bool):
    """Structured k_noise vjp for the SE family (gp_tpu kernels.py:84-128).

    With E = Q o K = (Kinv o K) - (alpha alpha^T o K), every reduction the
    hyp gradient needs is a column of E @ [a | 1] (a = x/l), and the
    rank-1 part contracts as alpha o (K @ (alpha o R)): two skinny GEMMs
    reading Kinv and K once each, no N^2 Q buffer.  Rows >= n_real (the
    decoy rows of gp_tpu's far-pad path) are masked out of `a` and of the
    row sums, which reproduces the zeroed-decoy-diagonal cotangent.
    """

    def vjp_q(chyp, sn2, x, n_real: int, K, Kinv, alpha):
        n, d = x.shape
        inv_l = torch.exp(-chyp[:d]) if ard else torch.exp(-chyp[0])
        a = x * inv_l
        if n_real < n:
            a[n_real:] = 0.0
        rhs = torch.cat([a, torch.ones((n, 1), dtype=a.dtype,
                                       device=a.device)], dim=1)
        M = (Kinv * K) @ rhs - alpha[:, None] * (K @ (alpha[:, None] * rhs))
        rs = M[:, d]
        per_dim = 2.0 * ((a * a).T @ rs - torch.sum(a * M[:, :d], dim=0))
        tr_r = (torch.sum(torch.diagonal(Kinv)[:n_real])
                - torch.dot(alpha[:n_real], alpha[:n_real]))
        # dk/dlog sf = 2 k0; E uses K (noise diag): 2 sum E - 2 sn2 tr_r
        g_logsf = 2.0 * torch.sum(rs[:n_real]) - 2.0 * sn2 * tr_r
        if ard:
            g_chyp = torch.cat([per_dim, g_logsf[None]])
        else:
            g_chyp = torch.stack([torch.sum(per_dim), g_logsf])
        return g_chyp.to(chyp.dtype), tr_r

    return vjp_q


# --------------------------------------------------------------------------
# SE-ARD: k(x,z) = sf^2 exp(-1/2 sum_i (x_i-z_i)^2 / l_i^2)   (CovSEard.cpp:7-11)
# --------------------------------------------------------------------------

def _seard_diag_k(chyp, x):
    sf2 = torch.exp(2.0 * chyp[x.shape[-1]])
    return sf2.to(x.dtype).expand(x.shape[0])


def _seard_default_hyp(x, y):
    """log l_i = log std(x_i), log sf = log std(y)  (CovSEard.cpp:72-79)."""
    x = np.asarray(x)
    y = np.asarray(y).ravel()
    hyp = np.empty(x.shape[1] + 1)
    with np.errstate(divide="ignore"):  # constant column/target -> -inf
        hyp[:-1] = np.log(np.std(x, axis=0, ddof=1))
        hyp[-1] = np.log(np.std(y, ddof=1))
    return hyp


def _lscale_bounds_per_dim(x):
    """Per-dimension length-scale box from the data span (CovSEard.cpp:46-66)."""
    x = np.asarray(x)
    span = x.max(axis=0) - x.min(axis=0)
    thres = 1e-4
    with np.errstate(divide="ignore"):
        lb = np.log(0.05 * span) - 0.5 * np.log(-2.0 * np.log(1.5 * DBL_MIN))
        ub1 = 0.5 * np.log(0.05 * DBL_MAX)
        ub2 = np.log(span / np.sqrt(-2.0 * np.log(1.0 - thres)))
    ub = np.minimum(ub1, ub2)
    return lb, ub


def _seard_hyp_range(x, y):
    x = np.asarray(x)
    y = np.asarray(y).ravel()
    d = x.shape[1]
    lb = np.full(d + 1, -np.inf)
    ub = np.full(d + 1, 0.5 * np.log(0.5 * DBL_MAX))
    lb[:d], ub[:d] = _lscale_bounds_per_dim(x)
    yrange = y.max() - y.min()
    lb[d] = np.log(max(DBL_EPS, DBL_EPS * yrange))        # CovSEard.cpp:68
    ub[d] = np.log(max(10 * DBL_EPS, 10 * yrange))        # CovSEard.cpp:69
    return lb, ub


SE_ARD = KernelSpec(
    name="se_ard",
    num_hyp=lambda dim: dim + 1,
    k=seard_k,
    diag_k=_seard_diag_k,
    default_hyp=_seard_default_hyp,
    hyp_range=_seard_hyp_range,
    k_noise=seard_k_noise,
    k_noise_vjp_q=_se_noise_vjp_q(True),
)


# --------------------------------------------------------------------------
# SE-iso: k(x,z) = sf^2 exp(-1/2 |x-z|^2 / l^2)   (CovSEiso.cpp:6-11)
# --------------------------------------------------------------------------

def _seiso_diag_k(chyp, x):
    sf2 = torch.exp(2.0 * chyp[1])
    return sf2.to(x.dtype).expand(x.shape[0])


def _seiso_default_hyp(x, y):
    """log l = 0, log sf = log std(y)  (CovSEiso.cpp:79-85)."""
    y = np.asarray(y).ravel()
    return np.array([0.0, np.log(np.std(y, ddof=1))])


def _seiso_hyp_range(x, y):
    """Intersects the per-dim boxes across dims (CovSEiso.cpp:70-71)."""
    x = np.asarray(x)
    y = np.asarray(y).ravel()
    lb = np.full(2, -np.inf)
    ub = np.full(2, 0.5 * np.log(0.5 * DBL_MAX))
    lb_d, ub_d = _lscale_bounds_per_dim(x)
    lb[0] = max(lb[0], lb_d.max())
    ub[0] = min(ub[0], ub_d.min())
    yrange = y.max() - y.min()
    with np.errstate(divide="ignore"):
        lb[1] = np.log(max(0.0, DBL_EPS * yrange))
        ub[1] = np.log(10 * yrange)
    return lb, ub


SE_ISO = KernelSpec(
    name="se_iso",
    num_hyp=lambda dim: 2,
    k=seiso_k,
    diag_k=_seiso_diag_k,
    default_hyp=_seiso_default_hyp,
    hyp_range=_seiso_hyp_range,
    k_noise=seiso_k_noise,
    k_noise_vjp_q=_se_noise_vjp_q(False),
)


KERNELS = {"se_ard": SE_ARD, "se_iso": SE_ISO}


def get_kernel(name_or_spec) -> KernelSpec:
    """Factory mirroring GP::_specify_cov (GP.cpp:575-587)."""
    if isinstance(name_or_spec, KernelSpec):
        return name_or_spec
    try:
        return KERNELS[str(name_or_spec).lower()]
    except KeyError:
        raise ValueError(
            f"Unknown kernel {name_or_spec!r}; available: {sorted(KERNELS)}"
        ) from None
