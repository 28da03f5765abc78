"""Plain exact Gaussian-process regression with the SE-ARD covariance, in
PyTorch: the reference that judges the port's answers.

It imports torch, numpy and the standard library only: nothing of the
program (gp_tpu_torch), of gp_tpu or of JAX.  It works everything out from
the rows, targets and hyperparameters that the benchmark hands it, in the
reference's own way: K by the expansion |a|^2 + |b|^2 - 2 a.b of the
scaled rows, the library Cholesky, triangular solves, and the gradients
written out per input dimension.

The hyperparameter vector is the library's (GP.cpp:85-92):
[log l_1 .. log l_d, log sf, log sn, mean]; sn = 0 is log sn = -inf.

`prec` is "float64" (the reference) or "tf32", the control: float32
storage with every matrix product's operands rounded to TF32's 10-bit
mantissa (sums in float32, as the tensor cores do), the step below the
float32 with TF32 off that the program runs.  Where the control's factor
fails, the posterior raises the noise as the library's posterior does
(x sqrt(10), GP.cpp:431-440), so that it still gives numbers.
"""

from __future__ import annotations

import math

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def dtype_of(prec: str) -> torch.dtype:
    if prec not in ("float64", "tf32"):
        raise ValueError(f"unknown precision {prec!r}")
    return torch.float64 if prec == "float64" else torch.float32


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 `a` rounded to TF32 (10 mantissa bits), to nearest even."""
    b = a.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    return ((b + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def _mm(a, b, prec: str):
    if prec == "tf32":
        return round_tf32(a) @ round_tf32(b)
    return a @ b


def k_se(x1, x2, hyp, prec: str):
    """K(x1, x2) (no noise): sf2 exp(-|(x1_i - x2_j) / l|^2 / 2)."""
    d = x1.shape[1]
    inv_l = torch.exp(-hyp[:d])
    a, b = x1 * inv_l, x2 * inv_l
    d2 = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
          - 2.0 * _mm(a, b.T, prec)).clamp_min_(0.0)
    return torch.exp(2.0 * hyp[d]) * torch.exp(-0.5 * d2)


def k_noise(x, hyp, sn2, prec: str, block: int = 4096):
    """K(x, x) + sn2 I, built in row blocks into one (n, n) buffer."""
    n = x.shape[0]
    K = torch.empty((n, n), dtype=x.dtype, device=x.device)
    for i in range(0, n, block):
        K[i:i + block] = k_se(x[i:i + block], x, hyp, prec)
    K.diagonal().add_(sn2)
    return K


def as_hyp(hyp, x):
    return torch.as_tensor(hyp, dtype=torch.float64).to(x.device, x.dtype)


def factor(x, hyp, prec: str):
    """The lower Cholesky factor of K + sn2 I, or None where it fails."""
    sn2 = float(torch.exp(2.0 * hyp[-2]))
    K = k_noise(x, hyp, sn2, prec)
    L, info = torch.linalg.cholesky_ex(K)
    del K
    if int(info) != 0 or not bool(torch.isfinite(L.diagonal()).all()):
        return None
    return L


def nll(x, y, hyp, prec: str) -> float:
    """Negative log marginal likelihood; +inf where the factor fails."""
    L = factor(x, hyp, prec)
    if L is None:
        return math.inf
    r = (y - hyp[-1])[:, None]
    alpha = torch.cholesky_solve(r, L)[:, 0]
    v = (0.5 * torch.dot(r[:, 0], alpha) + torch.log(L.diagonal()).sum()
         + x.shape[0] * _HALF_LOG_2PI)
    return float(v)


def nll_grad(x, y, hyp, prec: str):
    """(NLL, gradient over the whole hyperparameter vector); (inf, 0)
    where the factor fails, as the library's objective sanitizes it.

        Q = K^-1 - alpha alpha^T
        d/dlog l_k  = 1/2 sum(Q o K0 o (x_ik - x_jk)^2 / l_k^2)
        d/dlog sf   = sum(Q o K0)
        d/dlog sn   = sn2 tr(Q)
        d/dmean     = -sum(alpha)
    """
    n, d = x.shape
    L = factor(x, hyp, prec)
    if L is None:
        return math.inf, torch.zeros_like(hyp)
    r = (y - hyp[-1])[:, None]
    alpha = torch.cholesky_solve(r, L)[:, 0]
    f = float(0.5 * torch.dot(r[:, 0], alpha)
              + torch.log(L.diagonal()).sum() + n * _HALF_LOG_2PI)
    Q = torch.cholesky_inverse(L)
    del L
    Q -= alpha[:, None] * alpha[None, :]
    sn2 = torch.exp(2.0 * hyp[-2])
    tr_q = Q.diagonal().sum()
    E = k_se(x, x, hyp, prec)
    E *= Q
    del Q
    g = torch.empty_like(hyp)
    inv_l2 = torch.exp(-2.0 * hyp[:d])
    for k in range(d):
        dk = x[:, k]
        g[k] = 0.5 * inv_l2[k] * (E * (dk[:, None] - dk[None, :]) ** 2).sum()
    g[d] = E.sum()
    g[d + 1] = sn2 * tr_q
    g[d + 2] = -alpha.sum()
    return f, g


def posterior(x, y, hyp, prec: str, max_tries: int = 64):
    """(hyp', L, alpha): the factor at hyp, the noise raised by
    sqrt(10) steps (from log eps where it is -inf) while it fails."""
    hyp = hyp.clone()
    log_eps = math.log(torch.finfo(x.dtype).eps)
    for _ in range(max_tries + 1):
        L = factor(x, hyp, prec)
        if L is not None:
            alpha = torch.cholesky_solve((y - hyp[-1])[:, None], L)[:, 0]
            return hyp, L, alpha
        ls = float(hyp[-2])
        hyp[-2] = log_eps if math.isinf(ls) else ls + 0.5 * math.log(10.0)
    raise RuntimeError("reference posterior: no factor after noise "
                       "inflation")


def _noise_terms(hyp):
    d = hyp.shape[0] - 3
    return torch.exp(2.0 * hyp[d]), torch.exp(2.0 * hyp[-2])


def predict(x, hyp, L, alpha, xs, prec: str, block: int = 2048):
    """(mu, s2) at the rows xs: mean + k* alpha and
    max(sf2 - |L^-1 k*|^2, 0) + sn2, in blocks of rows."""
    sf2, sn2 = _noise_terms(hyp)
    mus, s2s = [], []
    for i in range(0, xs.shape[0], block):
        kt = k_se(xs[i:i + block], x, hyp, prec)
        mus.append(hyp[-1] + _mm(kt, alpha[:, None], prec)[:, 0])
        v = torch.linalg.solve_triangular(L, kt.T, upper=False)
        s2s.append(torch.clamp(sf2 - (v * v).sum(0), min=0.0) + sn2)
    return torch.cat(mus), torch.cat(s2s)


def predict_with_grad(x, hyp, L, alpha, xs, prec: str):
    """(mu, dmu/dxs, s2, ds2/dxs) at the rows xs.  With
    dk(x*, x_j)/dx* = -k_j (x* - x_j) / l^2:

        dmu/dx*  = -(x* w - (k* o alpha) x) / l^2,   w = k* alpha
        ds2/dx*  = 2 (x* z - (k* o u^T) x) / l^2,    u = K^-1 k*,
                                                     z = sum(k* o u^T)

    s2 is clamped at 0 and its gradient is not (GP.cpp:283, 294)."""
    d = x.shape[1]
    sf2, sn2 = _noise_terms(hyp)
    inv_l2 = torch.exp(-2.0 * hyp[:d])
    kt = k_se(xs, x, hyp, prec)                     # (m, n)
    w = _mm(kt, alpha[:, None], prec)[:, 0]
    mu = hyp[-1] + w
    gmu = -(xs * w[:, None] - _mm(kt * alpha[None, :], x, prec)) * inv_l2
    u = torch.cholesky_solve(kt.T.contiguous(), L)  # (n, m)
    ku = kt * u.T
    z = ku.sum(1)
    s2 = torch.clamp(sf2 - z, min=0.0) + sn2
    gs2 = 2.0 * (xs * z[:, None] - _mm(ku, x, prec)) * inv_l2
    return mu, gmu, s2, gs2


def default_hyp(x, y, noise_lb: float = 1e-3):
    """The library's start (GP.cpp:85-92, CovSEard.cpp:72-79): log l_k =
    log std(x_k), log sf = log std(y), log sn = max(log noise_lb,
    log(std(y) 1e-3)), mean = mean(y); std with ddof 1."""
    sy = torch.std(y)
    return torch.cat([torch.log(torch.std(x, dim=0)), torch.log(sy)[None],
                      torch.log(torch.clamp(sy * 1e-3, min=noise_lb))[None],
                      torch.mean(y)[None]])


def standardized(y):
    """(y - mean) / std(ddof 1) and the two constants: the units in which
    the library's optimizer runs (models/base.py's hyp_to_std)."""
    mu, sigma = float(torch.mean(y)), float(torch.std(y))
    return (y - mu) / sigma, mu, sigma


_DBL_EPS = 2.220446049250313e-16
_DBL_MIN = 2.2250738585072014e-308
_DBL_MAX = 1.7976931348623157e+308


def hyp_bounds(x, y, noise_lb: float = 1e-3):
    """(lb, ub): the box in which the library's optimizer keeps the
    hyperparameters (GP.cpp:514-534, CovSEard.cpp:46-69), widened by
    DBL_EPS on both sides.  Per dimension the length scale lies between
    0.05 of the data's span, over sqrt(-2 log(1.5 DBL_MIN)), and the span
    over sqrt(-2 log(1 - 1e-4)); sf between DBL_EPS and 10 times the
    targets' range; sn from noise_lb up to the larger of 10 noise_lb and
    sf's upper end; the mean within the targets' range."""
    d = x.shape[1]
    span = (x.max(0).values - x.min(0).values).double().cpu()
    yr = float(y.max() - y.min())
    lb = torch.empty(d + 3, dtype=torch.float64)
    ub = torch.empty(d + 3, dtype=torch.float64)
    lb[:d] = (torch.log(0.05 * span)
              - 0.5 * math.log(-2.0 * math.log(1.5 * _DBL_MIN)))
    ub[:d] = torch.clamp(torch.log(span / math.sqrt(
        -2.0 * math.log(1.0 - 1e-4))), max=0.5 * math.log(0.05 * _DBL_MAX))
    lb[d] = math.log(max(_DBL_EPS, _DBL_EPS * yr))
    ub[d] = math.log(max(10 * _DBL_EPS, 10 * yr))
    lb[d + 1] = math.log(noise_lb)
    ub[d + 1] = max(math.log(10 * noise_lb), float(ub[d]))
    lb[d + 2], ub[d + 2] = float(y.min()), float(y.max())
    return lb - _DBL_EPS, ub + _DBL_EPS


def to_standardized(hyp, mu: float, sigma: float):
    """A hyperparameter vector in the units of standardized(y): sf and sn
    over sigma, the mean (mean - mu) / sigma."""
    h = hyp.clone()
    h[-3:-1] -= math.log(sigma)
    h[-1] = (h[-1] - mu) / sigma
    return h


def from_standardized(hyp, mu: float, sigma: float):
    h = hyp.clone()
    h[-3:-1] += math.log(sigma)
    h[-1] = h[-1] * sigma + mu
    return h


def projected_gradient(v, g, lb, ub) -> float:
    """max |clamp(v - g, lb, ub) - v|: the gradient with the components
    that push out of the box at a bound taken away; 0 at a stationary
    point of the box."""
    return float(torch.max(torch.abs(torch.clamp(v - g, lb, ub) - v)))
