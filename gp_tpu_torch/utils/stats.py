"""Statistical helpers of the reference's util layer, on tensors
(counterpart of gp_tpu/utils/stats.py).

stdvar/stddev (util.h:32-41), normpdf/normcdf (util.cpp:110-119), logphi,
the GPML log-normal-CDF approximation with its gradient (util.cpp:121-180),
the Bayesian-optimisation comparisons violation / is_feas / better /
find_best (util.cpp:181-228), rand_matrix (util.cpp:230-245) and the
option helpers of util.h:11-56.  Vectorized as gp_tpu's are: the
reference's scalar branches are torch.where selections.

rand_matrix draws from an explicit source, a torch.Generator or the
port's draw source (optim/multistart.py), where gp_tpu takes a jax.random
key.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _t(x, dtype=None):
    """x as a tensor (lists and numpy through numpy: Python floats are
    float64, as in gp_tpu's 64-bit mode)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
    return t if dtype is None else t.to(dtype)


def stdvar(v):
    """Unbiased sample variance (N-1 denominator), util.h:32-37."""
    v = _t(v)
    n = v.shape[0]
    mean = torch.sum(v) / n
    return torch.sum((v - mean) ** 2) / (n - 1)


def stddev(v):
    return torch.sqrt(stdvar(v))


def normpdf(x):
    x = _t(x)
    return torch.exp(-0.5 * x ** 2) / math.sqrt(2 * math.pi)


def normcdf(x):
    x = _t(x)
    return 0.5 * torch.special.erfc(-x / math.sqrt(2.0))


# --- logphi: log(normcdf(x)) and its derivative -----------------------------
# GPML's logphi.m in three branches, as the reference's util.cpp:142-180

_LOGPHI_C = (
    0.00048204, -0.00142906, 0.0013200243174, 0.0009461589032,
    -0.0045563339802, 0.00556964649138, 0.00125993961762116,
    -0.01621575378835404, 0.02629651521057465, -0.001829764677455021,
    2 * (1 - math.pi / 3), (4 - math.pi) / 3, 1.0, 1.0,
)
_LOGPHI_R = (
    1.2753666447299659525, 5.019049726784267463450, 6.1602098531096305441,
    7.409740605964741794425, 2.9788656263939928886,
)
_LOGPHI_Q = (
    2.260528520767326969592, 9.3960340162350541504, 12.048951927855129036034,
    17.081440747466004316, 9.608965327192787870698, 3.3690752069827527677,
)


def logphi(x):
    """(lp, dlp): log Phi(x) and its derivative, elementwise."""
    x = _t(x)

    # |x| small (x^2 < 0.0492): a 14-term polynomial in lp0
    lp0 = -x / math.sqrt(2 * math.pi)
    f = torch.zeros_like(x)
    for ci in _LOGPHI_C:
        f = lp0 * (ci + f)
    lp_small = -2.0 * f - math.log(2.0)

    # x very negative (x < -11.3137): the rational asymptote
    num = torch.full_like(x, 0.5641895835477550741)
    for ri in _LOGPHI_R:
        num = -x * num / math.sqrt(2.0) + ri
    den = torch.ones_like(x)
    for qi in _LOGPHI_Q:
        den = -x * den / math.sqrt(2.0) + qi
    lp_neg = torch.log(0.5 * num / den) - 0.5 * x ** 2

    # elsewhere: erfc directly
    lp_mid = torch.log(0.5 * torch.special.erfc(-x / math.sqrt(2.0)))

    lp = torch.where(x ** 2 < 0.0492, lp_small,
                     torch.where(x < -11.3137, lp_neg, lp_mid))
    dlp = torch.where(
        x < -11.3137,
        torch.abs(den / num) * math.sqrt(2.0 / math.pi),
        torch.exp(-0.5 * x ** 2 - lp) / math.sqrt(2 * math.pi))
    return lp, dlp


# --- BO feasibility-rule comparisons (util.cpp:181-228) ---------------------
# A row is [objective, constraint_1, ..., constraint_c]; it is feasible when
# every constraint value is <= 0.

def violation(rec):
    rec = _t(rec)
    if rec.shape[-1] == 1:
        return torch.zeros(rec.shape[:-1], dtype=rec.dtype,
                           device=rec.device)
    return torch.sum(torch.clamp(rec[..., 1:], min=0.0), dim=-1)


def is_feas(rec):
    return violation(rec) <= 0


def better(rec1, rec2):
    """Feasibility rule: prefer lower violation, then lower objective."""
    rec1, rec2 = _t(rec1), _t(rec2)
    cv1, cv2 = violation(rec1), violation(rec2)
    f1, f2 = rec1[..., 0], rec2[..., 0]
    false = torch.zeros_like(f1 < f2)
    return torch.where((cv1 > 0) & (cv2 > 0), cv1 < cv2,
                       torch.where(cv1 > 0, false,
                                   torch.where(cv2 > 0, ~false, f1 < f2)))


def find_best(ys):
    """(index, row) of the best record under the feasibility rule: the
    lowest objective among feasible rows, else the lowest violation."""
    ys = _t(ys)
    cv = violation(ys)
    feas = cv <= 0
    obj_key = torch.where(feas, ys[..., 0], torch.full_like(cv, math.inf))
    idx = torch.where(torch.any(feas), torch.argmin(obj_key),
                      torch.argmin(cv))
    return idx, ys[idx]


def find_best_xy(xs, ys):
    """(best_x, best_y) over columns of xs / rows of ys (util.cpp:214-228).

    xs: (dim, n) points as columns (the reference's layout); ys: (n, 1+c)."""
    idx, best_y = find_best(ys)
    return _t(xs)[:, idx], best_y


def rand_matrix(draws, num_col: int, lb, ub, dtype=None):
    """Uniform points in the box [lb, ub], shape (dim, num_col): columns
    are points (util.cpp:230-245).  `draws` is a torch.Generator or a draw
    source with uniform(shape, dtype, device) in [0, 1); the result is
    lb + (ub - lb) (u + 1) / 2 with u = 2 U[0, 1) - 1, gp_tpu's uniform on
    [-1, 1)."""
    lb, ub = _t(lb, dtype), _t(ub, dtype)
    shape = (lb.shape[0], num_col)
    if isinstance(draws, torch.Generator):
        u01 = torch.rand(shape, generator=draws, dtype=lb.dtype,
                         device=draws.device).to(lb.device)
    else:
        u01 = draws.uniform(shape, lb.dtype, lb.device)
    u = 2.0 * u01 - 1.0
    a = 0.5 * (ub - lb)
    b = 0.5 * (ub + lb)
    return a[:, None] * u + b[:, None]


# --------------------------------------------------------------------------
# Generic helpers of util.h:11-56 (the reference's option lookups and top-k
# selection, kept for API parity)
# --------------------------------------------------------------------------

def top_largest(v, k: int):
    """Indices of the k largest entries, largest first (util.h:43-56)."""
    v = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                   else v).ravel()
    k = min(int(k), v.size)
    idx = np.argpartition(-v, k - 1)[:k]
    return idx[np.argsort(-v[idx])]


def with_default(mapping, key, default):
    """util.h:11-20: option lookup with fallback."""
    return mapping.get(key, default)


def get_required(mapping, key):
    """util.h:22-30: option lookup that raises when absent."""
    try:
        return mapping[key]
    except KeyError:
        raise KeyError(f"required option {key!r} not set") from None
