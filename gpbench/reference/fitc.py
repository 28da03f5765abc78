"""Plain FITC regression (Snelson & Ghahramani 2006) with the SE-ARD
covariance, in PyTorch: the reference that judges the port's FITC.

It imports torch and the standard library only: nothing of the program
(gp_tpu_torch), of gp_tpu or of JAX.  Every function computes in the
dtype of the rows it is given (float64 for the judge; float32 for the
control, the precision below the configuration's float64), with plain
products.

The model is the upstream library's FITC (FITC.cpp) as its `fitc N M`
demo runs it (test_fitc.cpp): SE-ARD, a constant mean, the inducing rows
U fixed, and the jitter j = (0.1 noise_lb)^2 = 1e-8 (FITC.cpp:27-31) on
Kuu.  With Q = Kxu Kuu^-1 Kux, Kuu jittered:

  Gamma = 1 + (sf2 - diag Q) / sn2                        (FITC.cpp:215)
  A     = sn2 Kuu + Kux Gamma^-1 Kxu                      (FITC.cpp:217)
  NLL   = 0.5 [ r^T Gamma^-1 (r - Kxu A^-1 Kux Gamma^-1 r) / sn2
              + log|A| - log|Kuu| + sum log Gamma + (N - M) log sn2
              + N log 2 pi ],      r = y - mean           (FITC.cpp:220-227)

The NLL is worked out here in the whitened form, not in A's: with
Luu Luu^T = Kuu, V = Luu^-1 Kux and B = I + V Gamma^-1 V^T / sn2 (so that
A = sn2 Luu B Luu^T),

  log|A| - log|Kuu| + (N - M) log sn2 = log|B| + N log sn2,
  Kxu A^-1 Kux = V^T B^-1 V / sn2.

The same function in exact arithmetic, rounded differently.

The posterior is FITC::_setK's (FITC.cpp:165-200): Luu of the jittered
Kuu, A from the raw Kuu (FITC.cpp:180), the jitter doubled on both
factors until both are SPD, alpha = A^-1 Kux Gamma^-1 r; a prediction is
FITC::_predict's (FITC.cpp:109-117): mean + K*u alpha and
max(sn2 + sf2 - diag(K*u (Kuu^-1 - sn2 A^-1) Ku*), sn2).

Departures from FITC.cpp:
  - the gradient is torch autograd of the NLL above, not FITC.cpp:237-315's
    analytic form: the derivative of the same function;
  - diag Q is held at or below sf2 (the Nystrom residual clamped at 0), as
    gp_tpu and its port do: the residual is >= 0 in exact arithmetic, and
    0 exactly at an inducing row;
  - the hyperparameters may come in the units of the standardized targets
    (y - mean(y)) / std(y), in which the port's optimizer runs: the caller
    then passes the jitter in those units, j / std(y)^2 (the NLL is the
    original-units NLL less N log std(y)).  FITC.cpp fits in the original
    units.

The hyperparameter vector is the library's (GP.cpp:85-92):
[log l_1 .. log l_d, log sf, log sn, mean].
"""

from __future__ import annotations

import math

import torch

NOISE_LB = 1e-3                 # GP.cpp:28
JITTER = (0.1 * NOISE_LB) ** 2  # FITC.cpp:27-31
_LOG_2PI = math.log(2.0 * math.pi)


def inducing(x, m: int):
    """The demo's inducing rows: the last m training rows
    (test_fitc.cpp's train_x.rightCols(M))."""
    return x[-m:]


def k_se(x1, x2, hyp):
    """SE-ARD K(x1, x2), no noise: sf2 exp(-|(x1_i - x2_j) / l|^2 / 2),
    differentiable in hyp."""
    d = x1.shape[1]
    inv_l = torch.exp(-hyp[:d])
    a, b = x1 * inv_l, x2 * inv_l
    d2 = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
          - 2.0 * (a @ b.T))
    return torch.exp(2.0 * hyp[d]) * torch.exp(-0.5 * d2.clamp(min=0.0))


def _chol(K):
    """The lower factor, or None where K is not numerically SPD."""
    L, info = torch.linalg.cholesky_ex(K)
    if int(info) != 0 or not bool(torch.isfinite(L.diagonal()).all()):
        return None
    return L


def _whitened(x, hyp, u, jitter):
    """(sf2, sn2, Luu, V, Gamma) at hyp, or None where Luu fails."""
    d, m = x.shape[1], u.shape[0]
    sf2 = torch.exp(2.0 * hyp[d])
    sn2 = torch.exp(2.0 * hyp[d + 1])
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    Luu = _chol(k_se(u, u, hyp) + jitter * eye)
    if Luu is None:
        return None
    V = torch.linalg.solve_triangular(Luu, k_se(u, x, hyp), upper=False)
    qdiag = (V * V).sum(0)
    gamma = 1.0 + torch.clamp(sf2 - qdiag, min=0.0) / sn2
    return sf2, sn2, Luu, V, gamma


def nll_value(x, y, hyp, u, jitter):
    """The NLL as a tensor (differentiable in hyp); None where a factor
    fails."""
    n, m = x.shape[0], u.shape[0]
    w = _whitened(x, hyp, u, jitter)
    if w is None:
        return None
    _, sn2, _, V, gamma = w
    r = y - hyp[-1]
    b = r / gamma
    B = torch.eye(m, dtype=x.dtype, device=x.device) + (V / gamma) @ V.T / sn2
    LB = _chol(B)
    if LB is None:
        return None
    c = torch.linalg.solve_triangular(LB, (V @ b)[:, None], upper=False)
    fit = (torch.dot(r, b) - (c * c).sum() / sn2) / sn2
    complexity = (2.0 * torch.log(LB.diagonal()).sum()
                  + torch.log(gamma).sum() + n * torch.log(sn2))
    return 0.5 * (fit + complexity + n * _LOG_2PI)


def nll(x, y, hyp, u, jitter=JITTER) -> float:
    """The NLL; +inf where a factor fails."""
    with torch.no_grad():
        v = nll_value(x, y, hyp, u, jitter)
    return math.inf if v is None or not bool(torch.isfinite(v)) else float(v)


def train_nll(x, y, hyp, u, jitter=JITTER) -> float:
    """The NLL that the library's train() returns at hyp: its final
    posterior (FITC::_setK) doubles the jitter until Kuu + jI and A are
    SPD and keeps it (the model's _jitter_u), and the final NLL is taken at
    that jitter; +inf where no jitter makes them SPD.  At the jitter
    itself wherever the first try succeeds."""
    try:
        post = posterior(x, y, hyp, u, jitter)
    except RuntimeError:
        return math.inf
    return nll(x, y, hyp, u, post.jitter)


def nll_grad(x, y, hyp, u, jitter=JITTER):
    """(NLL, its gradient over the whole hyperparameter vector), by
    autograd; (inf, 0) where a factor fails or a value is not finite, as
    the library's objective sanitizes it."""
    h = hyp.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        v = nll_value(x, y, h, u, jitter)
        if v is None or not bool(torch.isfinite(v)):
            return math.inf, torch.zeros_like(hyp)
        g, = torch.autograd.grad(v, h)
    if not bool(torch.isfinite(g).all()):
        return math.inf, torch.zeros_like(hyp)
    return float(v.detach()), g


class Posterior:
    """FITC::_setK's cache at hyp: the inducing rows u, the factors Luu
    (of Kuu + jitter I) and LA, alpha, and the jitter that made both
    SPD."""

    def __init__(self, u, hyp, Luu, LA, alpha, jitter: float):
        self.u, self.hyp, self.Luu, self.LA = u, hyp, Luu, LA
        self.alpha, self.jitter = alpha, jitter


@torch.no_grad()
def posterior(x, y, hyp, u, jitter=JITTER, max_tries: int = 64):
    """FITC::_setK: the factors of Kuu + jitter I and of A, the jitter
    doubled (and, from the first retry on, added to A) until both are
    SPD."""
    m = u.shape[0]
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    Kuu = k_se(u, u, hyp)
    Kxu = k_se(x, u, hyp)
    sf2 = torch.exp(2.0 * hyp[-3])
    sn2 = torch.exp(2.0 * hyp[-2])
    r = y - hyp[-1]
    for t in range(max_tries + 1):
        Luu = _chol(Kuu + jitter * eye)
        if Luu is not None:
            V = torch.linalg.solve_triangular(Luu, Kxu.T, upper=False)
            gamma = 1.0 + torch.clamp(sf2 - (V * V).sum(0), min=0.0) / sn2
            del V
            A = sn2 * Kuu + (Kxu.T / gamma) @ Kxu
            LA = _chol(A + (jitter if t else 0.0) * eye)
            if LA is not None:
                alpha = torch.cholesky_solve((Kxu.T @ (r / gamma))[:, None],
                                             LA)[:, 0]
                return Posterior(u, hyp, Luu, LA, alpha, jitter)
        jitter *= 2.0
    raise RuntimeError("reference FITC posterior: no factor after jitter "
                       "doubling")


@torch.no_grad()
def predict(post: Posterior, xs, block: int = 8192):
    """(mu, s2) at the rows xs, in blocks of rows."""
    hyp = post.hyp
    sf2 = torch.exp(2.0 * hyp[-3])
    sn2 = torch.exp(2.0 * hyp[-2])
    mus, s2s = [], []
    for i in range(0, xs.shape[0], block):
        Ksu = k_se(xs[i:i + block], post.u, hyp)
        mus.append(hyp[-1] + Ksu @ post.alpha)
        w1 = torch.linalg.solve_triangular(post.Luu, Ksu.T, upper=False)
        w2 = torch.linalg.solve_triangular(post.LA, Ksu.T, upper=False)
        quad = (w1 * w1).sum(0) - sn2 * (w2 * w2).sum(0)
        s2s.append(torch.clamp(sn2 + sf2 - quad, min=sn2))
    return torch.cat(mus), torch.cat(s2s)
