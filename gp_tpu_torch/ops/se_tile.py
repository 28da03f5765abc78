"""Stationary covariance builds through the CUDA tile kernel
(csrc/se_tile.cu).

Counterpart of gp_tpu/ops/pallas_kernels.py:

  se_matrix       K2, rectangular K(X1, X2)      (_se_tile_kernel)
  se_matrix_diag  K1, symmetric K(X, X) with the  (_se_tile_kernel_diag)
                  diagonal overwritten by dvals

each in the forms of gp_tpu's `_cov_from_sq` (`cov_from_sq` here): "se",
the Matern "m52" and "m32", and "rq" with alpha as the extra scalar p1.

Dispatch is by the device of the tensors alone.  A CUDA tensor launches
the kernel (float32 or float64, any size, any form) or raises; a CPU
tensor runs the plain version (`se_matrix_plain`, `se_matrix_diag_plain`),
the same formula in torch ops, which the tests and chip_smoke.py also use
as the yardstick for the kernel.  `launches[wrapper][form]` counts kernel
launches, one per launch, and nothing else.

The differentiable covariances (`cov_k(form, ard)`, `cov_k_noise(form,
ard)`; `seard_k` and the other SE names are their "se" instances) are
torch.autograd.Functions whose forward is the build above and whose
backward is the closed form of gp_tpu's custom VJPs (`_se_bwd_terms`,
`_matern_bwd_terms`, `_rq_bwd_terms`, pallas_kernels.py:256-273, 446-453,
563-572): the cotangent contracts against E2 = -2 G dk/dsq in GEMMs, with
E2 = G o K for SE and, for Matern and RQ, from sq recomputed in the
backward.  The log-sf gradient is 2 sum(G o K) from the forward's K.

Cotangent contract (pallas_kernels.py:327-334): when n_real < n, the
cotangent G handed to a k_noise backward must be zero on the rows >=
n_real of the diagonal.  The only correction the noise diagonal needs is
then on the log-sf gradient: -2 sn2 tr(G[:n_real, :n_real]).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .sdist import sqdist

FORMS = ("se", "m52", "m32", "rq")      # the kernel's `form` is the index

# kernel launches since the last reset, by wrapper and form
launches = {w: dict.fromkeys(FORMS, 0) for w in ("se_matrix",
                                                 "se_matrix_diag")}


def reset_launches() -> None:
    for by_form in launches.values():
        for f in by_form:
            by_form[f] = 0


_FN = {torch.float32: "se_tile_f32", torch.float64: "se_tile_f64"}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 5 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# the kernel reads the rows feature-major, each feature's row 16-byte
# aligned: the row length padded to a multiple of _ALIGN values
_ALIGN = 4

# Matern's a (rounded to the data's type where it multiplies a tensor)
# and the floor under sqrt that keeps the r = 0 gradient finite
M52_A = math.sqrt(5.0)
M32_A = math.sqrt(3.0)
R_FLOOR = 1e-32


def _check_form(form: str) -> None:
    if form not in FORMS:
        raise ValueError(f"unknown covariance form {form!r}; the kernel "
                         f"takes {FORMS}")


def _kernel_fn(dtype):
    """The C entry point for dtype, from the library built at first use."""
    fn = getattr(_build.load("se_tile"), _FN[dtype])
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _feature_major(x, inv_l):
    """The rows x (m, d) scaled by inv_l, as the kernel reads them: (d, m
    padded to _ALIGN); the kernel reads no column past m.  Built without
    grad (out= refuses inputs that require it): the kernel is no autograd
    op, its Functions below carry the gradient."""
    m, d = x.shape
    t = x.new_empty((d, -(-m // _ALIGN) * _ALIGN))
    with torch.no_grad():
        torch.mul(x.T, inv_l.reshape(-1, 1), out=t[:, :m])
    return t


def _launch(wrapper: str, form: str, a, b, inv_l, sf2, p1, dvals):
    """One launch of se_tile on the rows a (m, d), b (n, d) scaled by
    inv_l (K1: b is a)."""
    dev = a.device
    if a.dtype not in _FN:
        raise TypeError(f"{wrapper}: the CUDA kernel takes float32 or "
                        f"float64, not {a.dtype}")
    operands = [b, inv_l, sf2] + [t for t in (p1, dvals) if t is not None]
    for t in operands:
        if t.device != dev or t.dtype != a.dtype:
            raise ValueError(f"{wrapper}: operands must share device and "
                             f"dtype ({dev}, {a.dtype}); got {t.device}, "
                             f"{t.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"{wrapper}: rows must be (m, d) and (n, d); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if sf2.numel() != 1 or (p1 is not None and p1.numel() != 1):
        raise ValueError(f"{wrapper}: sf2 and p1 must hold one value each")
    m, d = a.shape
    n = b.shape[0]
    if dvals is not None and tuple(dvals.shape) != (m,):
        raise ValueError(f"{wrapper}: dvals must be ({m},)")
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    at = _feature_major(a, inv_l)
    bt = at if b is a else _feature_major(b, inv_l)
    sf2 = sf2.contiguous()
    p1 = p1.contiguous() if p1 is not None else None
    dvals = dvals.contiguous() if dvals is not None else None
    fn = _kernel_fn(a.dtype)
    ptr = lambda t: t.data_ptr() if t is not None else None
    with torch.cuda.device(dev):
        rc = fn(at.data_ptr(), bt.data_ptr(), sf2.data_ptr(), ptr(p1),
                ptr(dvals), out.data_ptr(), m, n, d, at.shape[1],
                bt.shape[1], FORMS.index(form), int(dvals is not None),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper}: se_tile ({form}) launch failed with "
                           f"CUDA error {rc}")
    launches[wrapper][form] += 1
    return out


def _scalar(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------------
# Builds (kernel on CUDA, plain version on the CPU)
# --------------------------------------------------------------------------

def cov_from_sq(form: str, sq, sf2, p1=None):
    """gp_tpu's _cov_from_sq: the covariance from the scaled squared
    distance, in the same operations and order as the kernel's map."""
    if form == "se":
        return sf2 * torch.exp(-0.5 * sq)
    if form == "rq":
        # (1 + sq/(2 alpha))^-alpha through log1p: stable for every alpha
        # in the box [1e-3, 1e3]
        return sf2 * torch.exp(-p1 * torch.log1p(sq / (2.0 * p1)))
    _check_form(form)
    ar = (M52_A if form == "m52" else M32_A) * torch.sqrt(sq + R_FLOOR)
    poly = 1.0 + ar
    if form == "m52":
        poly = poly + ar * ar / 3.0
    return sf2 * poly * torch.exp(-ar)


def se_matrix_plain(inv_l, sf2, x1, x2, form: str = "se", p1=1.0):
    """K(X1, X2) of `form` from |x1/l - x2/l|^2, plain torch ops."""
    _check_form(form)
    inv_l = _scalar(inv_l, x1)
    return cov_from_sq(form, sqdist(x1 * inv_l, x2 * inv_l),
                       _scalar(sf2, x1),
                       _scalar(p1, x1) if form == "rq" else None)


def se_matrix_diag_plain(inv_l, sf2, x, dvals, form: str = "se", p1=1.0):
    """se_matrix_plain(x, x) with the diagonal overwritten by dvals."""
    K = se_matrix_plain(inv_l, sf2, x, x, form, p1)
    K.diagonal().copy_(dvals)
    return K


def _dk_dsq(form: str, sq, sf2, p1):
    """|dk/dsq| (gp_tpu's comments, pallas_kernels.py:415-416, 541-542);
    each decreases in sq."""
    if form == "rq":
        return 0.5 * sf2 * torch.exp(-(p1 + 1.0) * torch.log1p(sq / (2.0
                                                                  * p1)))
    ar = (M52_A if form == "m52" else M32_A) * torch.sqrt(sq)
    if form == "m52":
        return sf2 * (5.0 / 6.0) * (1.0 + ar) * torch.exp(-ar)
    return sf2 * 1.5 * torch.exp(-ar)


def rounding_bound(inv_l, sf2, x1, x2, K, form: str = "se", p1=1.0):
    """Entrywise bound (m, n) on |K_kernel - K_plain| for a build K.

    Each build forms sq = |a|^2 + |b|^2 - 2 a.b from d-term sums, off by at
    most dsq = (2 d + 4) eps (|a|^2 + |b|^2).  K moves by at most
    max |dk/dsq| dsq over [sq - dsq, sq]: |dk/dsq| decreases in sq in
    every form, so it is taken at max(sq - dsq, 0) (for SE it is K / 2,
    and e^(dsq/2) - 1 is below rounding).  The map itself adds, relative
    to K: 2 eps for SE (exp and the scale); for Matern (4 + 2 ar) eps per
    term of ar = a sqrt(sq + floor) and of the polynomial, 12 eps + 3 ar
    eps in all, the ar term being the argument of exp; for RQ (3 + 2 sq)
    eps, from alpha log1p(sq / 2 alpha) <= sq / 2 as exp's argument, 6 eps
    + 3 sq eps with room.  Two builds: twice that.  Each entry is held to
    its own size, so the bound stays far below a typical entry however
    small the entries are; `tiny` covers entries that underflow."""
    _check_form(form)
    fi = torch.finfo(K.dtype)
    inv_l = _scalar(inv_l, x1)
    a, b = x1 * inv_l, x2 * inv_l
    n1 = torch.sum(a * a, dim=1)[:, None]
    n2 = torch.sum(b * b, dim=1)[None, :]
    d = x1.shape[1]
    sf2 = _scalar(sf2, K)
    if form == "se":
        return (K.abs() * fi.eps * ((2 * d + 4) * (n1 + n2) + 4)
                + sf2.abs() * fi.tiny)
    dsq = (2 * d + 4) * fi.eps * (n1 + n2)
    sq = sqdist(a, b)
    slope = _dk_dsq(form, torch.clamp(sq - dsq, min=0.0), sf2.abs(),
                    _scalar(p1, K) if form == "rq" else None)
    if form == "rq":
        map_rel = 6.0 + 3.0 * sq
    else:
        map_rel = 12.0 + 3.0 * (M52_A if form == "m52" else M32_A) \
            * torch.sqrt(sq)
    return (2.0 * (slope * dsq + fi.eps * map_rel * K.abs())
            + sf2.abs() * fi.tiny)


def se_matrix(inv_l, sf2, x1, x2, form: str = "se", p1=1.0):
    """K2: K(X1, X2) of `form` from |x1/l - x2/l|^2, (m, n); for the
    default "se", sf2 exp(-0.5 |x1/l - x2/l|^2).

    inv_l: per-dim inverse lengthscales (d,) [ARD] or a scalar [iso];
    sf2, p1 (RQ's alpha): one value each.  Scalars may be device tensors:
    they reach the kernel as pointers, with no host round trip."""
    _check_form(form)
    if x1.device.type == "cpu":
        return se_matrix_plain(inv_l, sf2, x1, x2, form, p1)
    return _launch("se_matrix", form, x1, x2, _scalar(inv_l, x1),
                   _scalar(sf2, x1), _scalar(p1, x1) if form == "rq"
                   else None, None)


def se_matrix_diag(inv_l, sf2, x, dvals, form: str = "se", p1=1.0):
    """K1: symmetric K(X, X) of `form` with the diagonal overwritten by
    dvals (n,)."""
    _check_form(form)
    if x.device.type == "cpu":
        return se_matrix_diag_plain(inv_l, sf2, x, dvals, form, p1)
    return _launch("se_matrix_diag", form, x, x, _scalar(inv_l, x),
                   _scalar(sf2, x), _scalar(p1, x) if form == "rq" else None,
                   _scalar(dvals, x))


# --------------------------------------------------------------------------
# Differentiable covariances (KernelSpec `k` / `k_noise` contract)
# --------------------------------------------------------------------------

def _split(chyp, d: int, ard: bool, form: str):
    """(inv_l, sf2, alpha or None) from [log l_1..l_d | log l, log sf
    (, log alpha for RQ)]."""
    nl = d if ard else 1
    inv_l = torch.exp(-chyp[:d]) if ard else torch.exp(-chyp[0])
    alpha = torch.exp(chyp[nl + 1]) if form == "rq" else None
    return inv_l, torch.exp(2.0 * chyp[nl]), alpha


def _e_terms(E, inv_l, x1, x2, need_dx1: bool = True, need_dx2: bool = True):
    """Reductions of E = -2 G o dk/dsq: (per-dim sum E (a_i - b_i)^2,
    dx1, dx2), each dx None when not needed (gp_tpu's _se_bwd_terms)."""
    a = x1 * inv_l
    b = x2 * inv_l
    rs = torch.sum(E, dim=1)
    cs = torch.sum(E, dim=0)
    Eb = E @ b
    per_dim = ((a * a).T @ rs + (b * b).T @ cs
               - 2.0 * torch.sum(a * Eb, dim=0))
    inv_l2 = inv_l * inv_l
    dx1 = (E @ x2 - rs[:, None] * x1) * inv_l2 if need_dx1 else None
    dx2 = (E.T @ x1 - cs[:, None] * x2) * inv_l2 if need_dx2 else None
    return per_dim, dx1, dx2


def _bwd_terms(form, K, G, inv_l, sf2, alpha, x1, x2, need_dx1, need_dx2):
    """(per_dim, g_logsf, g_logalpha or None, dx1, dx2): gp_tpu's
    _se_bwd_terms (se), _matern_bwd_terms (m52, m32), _rq_bwd_terms (rq)."""
    if form == "se":
        E = G * K
        per_dim, dx1, dx2 = _e_terms(E, inv_l, x1, x2, need_dx1, need_dx2)
        return per_dim, 2.0 * torch.sum(E), None, dx1, dx2
    sq = sqdist(x1 * inv_l, x2 * inv_l)
    g_loga = None
    if form == "rq":
        u = sq / (2.0 * alpha)
        lu = torch.log1p(u)
        E2 = G * (sf2 * torch.exp(-(alpha + 1.0) * lu))
    else:
        # _matern_e2: exact zeros wherever exp(-ar) underflows
        ar = (M52_A if form == "m52" else M32_A) * torch.sqrt(sq + R_FLOOR)
        c = (5.0 / 3.0) * (1.0 + ar) if form == "m52" else 3.0
        E2 = G * (sf2 * c * torch.exp(-ar))
    del sq
    per_dim, dx1, dx2 = _e_terms(E2, inv_l, x1, x2, need_dx1, need_dx2)
    del E2
    # dk/dlog sf = 2 k: from the forward's K, not from E2
    GK = G * K
    g_logsf = 2.0 * torch.sum(GK)
    if form == "rq":
        g_loga = torch.sum(GK * (alpha * (u / (1.0 + u) - lu)))
    return per_dim, g_logsf, g_loga, dx1, dx2


def _g_chyp(per_dim, g_logsf, g_loga, ard: bool):
    extra = [] if g_loga is None else [g_loga]
    if ard:
        return torch.cat([per_dim, g_logsf[None]] + [g[None] for g in extra])
    return torch.stack([torch.sum(per_dim), g_logsf] + extra)


class _CovK(torch.autograd.Function):
    """K(X1, X2) of `form` through K2; backward = gp_tpu's custom VJP of
    seard/seiso_k_pallas, matern_k_pallas and rq_k_pallas."""

    @staticmethod
    def forward(ctx, chyp, x1, x2, form, ard):
        inv_l, sf2, alpha = _split(chyp, x1.shape[-1], ard, form)
        K = se_matrix(inv_l, sf2, x1, x2, form, alpha)
        ctx.save_for_backward(K, chyp, x1, x2)
        ctx.form, ctx.ard = form, ard
        return K

    @staticmethod
    def backward(ctx, G):
        K, chyp, x1, x2 = ctx.saved_tensors
        inv_l, sf2, alpha = _split(chyp, x1.shape[-1], ctx.ard, ctx.form)
        per_dim, g_logsf, g_loga, dx1, dx2 = _bwd_terms(
            ctx.form, K, G, inv_l, sf2, alpha, x1, x2,
            ctx.needs_input_grad[1], ctx.needs_input_grad[2])
        return (_g_chyp(per_dim, g_logsf, g_loga, ctx.ard).to(chyp.dtype),
                None if dx1 is None else dx1.to(x1.dtype),
                None if dx2 is None else dx2.to(x2.dtype), None, None)


class _CovKNoise(torch.autograd.Function):
    """K(X, X) of `form` + sn2 I on rows < n_real (diag sf2 beyond)
    through K1; backward = gp_tpu's custom VJP of seard/seiso_k_noise_
    pallas, matern_k_noise_pallas and rq_k_noise_pallas."""

    @staticmethod
    def forward(ctx, chyp, sn2, x, n_real, form, ard):
        inv_l, sf2, alpha = _split(chyp, x.shape[-1], ard, form)
        n = x.shape[0]
        ids = torch.arange(n, device=x.device)
        dvals = torch.where(ids < n_real, sf2 + sn2, sf2).to(x.dtype)
        K = se_matrix_diag(inv_l, sf2, x, dvals, form, alpha)
        ctx.save_for_backward(K, chyp, sn2, x)
        ctx.form, ctx.ard, ctx.n_real = form, ard, n_real
        return K

    @staticmethod
    def backward(ctx, G):
        K, chyp, sn2, x = ctx.saved_tensors
        inv_l, sf2, alpha = _split(chyp, x.shape[-1], ctx.ard, ctx.form)
        need_dx = ctx.needs_input_grad[2]
        per_dim, g_logsf, g_loga, dx1, dx2 = _bwd_terms(
            ctx.form, K, G, inv_l, sf2, alpha, x, x, need_dx, need_dx)
        # the noise diagonal: E = G o K picks up sn2 G_ii on the real
        # diagonal (the (a - b)^2 and dx terms cancel there, and RQ's
        # log-alpha factor is 0 at u = 0)
        tr_r = torch.sum(torch.diagonal(G)[:ctx.n_real])
        g_logsf = g_logsf - 2.0 * sn2 * tr_r
        return (_g_chyp(per_dim, g_logsf, g_loga, ctx.ard).to(chyp.dtype),
                tr_r.to(chyp.dtype),
                (dx1 + dx2).to(x.dtype) if need_dx else None,
                None, None, None)


def cov_k(form: str, ard: bool):
    """The differentiable K(X1, X2) of `form` (KernelSpec `k`)."""
    _check_form(form)

    def k(chyp, x1, x2):
        return _CovK.apply(chyp, x1, x2, form, ard)
    return k


def cov_k_noise(form: str, ard: bool):
    """The differentiable K(X, X) + sn2 I (real rows; diag sf2 beyond
    n_real) of `form` (KernelSpec `k_noise`)."""
    _check_form(form)

    def k_noise(chyp, sn2, x, n_real: int):
        return _CovKNoise.apply(
            chyp, torch.as_tensor(sn2, dtype=x.dtype, device=x.device), x,
            int(n_real), form, ard)
    return k_noise


# SE-ARD (CovSEard.cpp:7-11), chyp = [log l_1..d, log sf]; SE-iso
# (CovSEiso.cpp:6-11), chyp = [log l, log sf]
seard_k = cov_k("se", True)
seiso_k = cov_k("se", False)
seard_k_noise = cov_k_noise("se", True)
seiso_k_noise = cov_k_noise("se", False)
