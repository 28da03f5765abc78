"""SE covariance builds through the CUDA tile kernel (csrc/se_tile.cu).

Counterpart of the SE half of gp_tpu/ops/pallas_kernels.py:

  se_matrix       K2, rectangular K(X1, X2)      (_se_tile_kernel)
  se_matrix_diag  K1, symmetric K(X, X) with the  (_se_tile_kernel_diag)
                  diagonal overwritten by dvals

Dispatch is by the device of the tensors alone.  A CUDA tensor launches
the kernel (float32 or float64, any size) or raises; a CPU tensor runs the
plain version (`se_matrix_plain`, `se_matrix_diag_plain`), the same
formula in torch ops, which the tests and chip_smoke.py also use as the
yardstick for the kernel.  `launches` counts kernel launches, one per
launch, and nothing else.

The differentiable covariances (`seard_k`, `seiso_k`, `seard_k_noise`,
`seiso_k_noise`) are torch.autograd.Functions whose forward is the build
above and whose backward is the closed form of gp_tpu's custom VJPs
(`_se_bwd_terms`, `_se_noise_bwd_terms`, pallas_kernels.py:256-273,
348-352): the cotangent of K contracts against K itself, in GEMMs.

Cotangent contract (pallas_kernels.py:327-334): when n_real < n, the
cotangent G handed to a k_noise backward must be zero on the rows >=
n_real of the diagonal.  The only correction the noise diagonal needs is
then on the log-sf gradient: -2 sn2 tr(G[:n_real, :n_real]).

The Matern / RQ forms of the same kernels wait for ROADMAP module 8.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .sdist import sqdist

# kernel launches since the last reset, by wrapper
launches = {"se_matrix": 0, "se_matrix_diag": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_FN = {torch.float32: "se_tile_f32", torch.float64: "se_tile_f64"}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [ctypes.c_int,
                                                             ctypes.c_void_p]


def _kernel_fn(dtype):
    """The C entry point for dtype, from the library built at first use."""
    fn = getattr(_build.load("se_tile"), _FN[dtype])
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _launch(wrapper: str, a, b, sf2, dvals):
    """One launch of se_tile on pre-scaled rows a (m, d), b (n, d)."""
    dev = a.device
    if a.dtype not in _FN:
        raise TypeError(f"{wrapper}: the CUDA kernel takes float32 or "
                        f"float64, not {a.dtype}")
    operands = [b, sf2] + ([dvals] if dvals is not None else [])
    for t in operands:
        if t.device != dev or t.dtype != a.dtype:
            raise ValueError(f"{wrapper}: operands must share device and "
                             f"dtype ({dev}, {a.dtype}); got {t.device}, "
                             f"{t.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"{wrapper}: rows must be (m, d) and (n, d); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if sf2.numel() != 1:
        raise ValueError(f"{wrapper}: sf2 must hold one value")
    m, d = a.shape
    n = b.shape[0]
    if dvals is not None and tuple(dvals.shape) != (m,):
        raise ValueError(f"{wrapper}: dvals must be ({m},)")
    a, b, sf2 = a.contiguous(), b.contiguous(), sf2.contiguous()
    if dvals is not None:
        dvals = dvals.contiguous()
    out = torch.empty((m, n), dtype=a.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    fn = _kernel_fn(a.dtype)
    with torch.cuda.device(dev):
        rc = fn(a.data_ptr(), b.data_ptr(), sf2.data_ptr(),
                dvals.data_ptr() if dvals is not None else None,
                out.data_ptr(), m, n, d, int(dvals is not None),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper}: se_tile launch failed with CUDA "
                           f"error {rc}")
    launches[wrapper] += 1
    return out


def _scalar(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


# --------------------------------------------------------------------------
# Builds (kernel on CUDA, plain version on the CPU)
# --------------------------------------------------------------------------

def se_matrix_plain(inv_l, sf2, x1, x2):
    """sf2 * exp(-0.5 |x1/l - x2/l|^2), plain torch ops."""
    inv_l = _scalar(inv_l, x1)
    return _scalar(sf2, x1) * torch.exp(-0.5 * sqdist(x1 * inv_l,
                                                      x2 * inv_l))


def se_matrix_diag_plain(inv_l, sf2, x, dvals):
    """se_matrix_plain(x, x) with the diagonal overwritten by dvals."""
    K = se_matrix_plain(inv_l, sf2, x, x)
    K.diagonal().copy_(dvals)
    return K


def rounding_bound(inv_l, sf2, x1, x2, K):
    """Entrywise bound (m, n) on |K_kernel - K_plain| for an SE build K.

    Each build forms sq = |a|^2 + |b|^2 - 2 a.b from d-term sums, off by at
    most (2 d + 4) eps (|a|^2 + |b|^2); K = sf2 exp(-sq/2) moves by
    K |d sq| / 2, and exp and the scale add 2 eps K.  Two builds: twice
    that.  Each entry is held to its own size, so the bound stays far
    below a typical entry however small the entries are; `tiny` covers
    entries that underflow."""
    fi = torch.finfo(K.dtype)
    inv_l = _scalar(inv_l, x1)
    n1 = torch.sum((x1 * inv_l) ** 2, dim=1)[:, None]
    n2 = torch.sum((x2 * inv_l) ** 2, dim=1)[None, :]
    d = x1.shape[1]
    return (K.abs() * fi.eps * ((2 * d + 4) * (n1 + n2) + 4)
            + _scalar(sf2, K).abs() * fi.tiny)


def se_matrix(inv_l, sf2, x1, x2):
    """K2: K(X1, X2) = sf2 exp(-0.5 |x1/l - x2/l|^2), (m, n).

    inv_l: per-dim inverse lengthscales (d,) [ARD] or a scalar [iso];
    sf2: one value.  Scalars may be device tensors: they reach the kernel
    as pointers, with no host round trip."""
    if x1.device.type == "cpu":
        return se_matrix_plain(inv_l, sf2, x1, x2)
    inv_l = _scalar(inv_l, x1)
    return _launch("se_matrix", x1 * inv_l, x2 * inv_l, _scalar(sf2, x1),
                   None)


def se_matrix_diag(inv_l, sf2, x, dvals):
    """K1: symmetric K(X, X) with the diagonal overwritten by dvals (n,)."""
    if x.device.type == "cpu":
        return se_matrix_diag_plain(inv_l, sf2, x, dvals)
    xs = x * _scalar(inv_l, x)
    return _launch("se_matrix_diag", xs, xs, _scalar(sf2, x),
                   _scalar(dvals, x))


# --------------------------------------------------------------------------
# Differentiable covariances (KernelSpec `k` / `k_noise` contract)
# --------------------------------------------------------------------------

def _split(chyp, d: int, ard: bool):
    """(inv_l, sf2) from [log l_1..l_d, log sf] or [log l, log sf]."""
    if ard:
        return torch.exp(-chyp[:d]), torch.exp(2.0 * chyp[d])
    return torch.exp(-chyp[0]), torch.exp(2.0 * chyp[1])


def _se_bwd_terms(K, G, inv_l, x1, x2):
    """E = G o K; returns (per-dim sum E (a_i-b_i)^2, sum 2E, dx1, dx2)."""
    E = G * K
    a = x1 * inv_l
    b = x2 * inv_l
    rs = torch.sum(E, dim=1)
    cs = torch.sum(E, dim=0)
    Eb = E @ b
    per_dim = ((a * a).T @ rs + (b * b).T @ cs
               - 2.0 * torch.sum(a * Eb, dim=0))
    g_logsf = 2.0 * torch.sum(E)
    inv_l2 = inv_l * inv_l
    dx1 = (E @ x2 - rs[:, None] * x1) * inv_l2
    dx2 = (E.T @ x1 - cs[:, None] * x2) * inv_l2
    return per_dim, g_logsf, dx1, dx2


def _g_chyp(per_dim, g_logsf, ard: bool):
    if ard:
        return torch.cat([per_dim, g_logsf[None]])
    return torch.stack([torch.sum(per_dim), g_logsf])


class _SEK(torch.autograd.Function):
    """K(X1, X2) through K2; backward = gp_tpu's _seard_bwd/_seiso_bwd."""

    @staticmethod
    def forward(ctx, chyp, x1, x2, ard):
        inv_l, sf2 = _split(chyp, x1.shape[-1], ard)
        K = se_matrix(inv_l, sf2, x1, x2)
        ctx.save_for_backward(K, chyp, x1, x2)
        ctx.ard = ard
        return K

    @staticmethod
    def backward(ctx, G):
        K, chyp, x1, x2 = ctx.saved_tensors
        inv_l, _ = _split(chyp, x1.shape[-1], ctx.ard)
        per_dim, g_logsf, dx1, dx2 = _se_bwd_terms(K, G, inv_l, x1, x2)
        return (_g_chyp(per_dim, g_logsf, ctx.ard).to(chyp.dtype),
                dx1.to(x1.dtype), dx2.to(x2.dtype), None)


class _SEKNoise(torch.autograd.Function):
    """K(X, X) + sn2 I on rows < n_real (diag sf2 beyond) through K1;
    backward = gp_tpu's _seard_noise_bwd/_seiso_noise_bwd."""

    @staticmethod
    def forward(ctx, chyp, sn2, x, n_real, ard):
        inv_l, sf2 = _split(chyp, x.shape[-1], ard)
        n = x.shape[0]
        ids = torch.arange(n, device=x.device)
        dvals = torch.where(ids < n_real, sf2 + sn2, sf2).to(x.dtype)
        K = se_matrix_diag(inv_l, sf2, x, dvals)
        ctx.save_for_backward(K, chyp, sn2, x)
        ctx.ard, ctx.n_real = ard, n_real
        return K

    @staticmethod
    def backward(ctx, G):
        K, chyp, sn2, x = ctx.saved_tensors
        inv_l, _ = _split(chyp, x.shape[-1], ctx.ard)
        per_dim, g_logsf, dx1, dx2 = _se_bwd_terms(K, G, inv_l, x, x)
        tr_r = torch.sum(torch.diagonal(G)[:ctx.n_real])
        g_logsf = g_logsf - 2.0 * sn2 * tr_r
        return (_g_chyp(per_dim, g_logsf, ctx.ard).to(chyp.dtype),
                tr_r.to(chyp.dtype), (dx1 + dx2).to(x.dtype), None, None)


def seard_k(chyp, x1, x2):
    """SE-ARD covariance (CovSEard.cpp:7-11), chyp = [log l_1..d, log sf]."""
    return _SEK.apply(chyp, x1, x2, True)


def seiso_k(chyp, x1, x2):
    """SE-iso covariance (CovSEiso.cpp:6-11), chyp = [log l, log sf]."""
    return _SEK.apply(chyp, x1, x2, False)


def seard_k_noise(chyp, sn2, x, n_real: int):
    """K(X, X) + sn2 I (real rows; diag sf2 beyond n_real), SE-ARD."""
    return _SEKNoise.apply(chyp, torch.as_tensor(sn2, dtype=x.dtype,
                                                 device=x.device),
                           x, int(n_real), True)


def seiso_k_noise(chyp, sn2, x, n_real: int):
    """K(X, X) + sn2 I (real rows; diag sf2 beyond n_real), SE-iso."""
    return _SEKNoise.apply(chyp, torch.as_tensor(sn2, dtype=x.dtype,
                                                 device=x.device),
                           x, int(n_real), False)
