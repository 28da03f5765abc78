"""Block Cholesky base cases through the CUDA kernels of csrc/chol_block.cu.

Counterpart of gp_tpu/ops/pallas_chol.py:

  chol_inv        K3, (L, L^-1) of one block in one launch (_chol_inv_kernel)
  cholesky_block  K4, L of one block                       (_chol_kernel)
  cholesky_panel  K5, L by left-looking rank-w panels      (_chol_panel_kernel)

K3 has two designs, picked by the block size alone (`k3_entry`): up to
K3_REG_MAX_B (the blocked factorization's leaf) the register-tiled kernel
behind the C entry chol_inv_reg, above it the shared-memory rank-1 loop
chol_rank1 behind chol_inv.  K4 (C entry chol) has two forms, also by
block size: up to K3_REG_MAX_B the same register kernel without T's
store, one launch; above it a blocked right-looking factorization, a
host loop of launches in the C entry: per panel of K4_PANEL columns the
register leaf in place, a panel solve and a trailing update across the
card's SMs, then the last panel's leaf.  K5 (C entry chol_panel) is
gp_tpu's left-looking factorization, a host loop of launches in the C
entry: per panel of w columns an update against the columns already
factored (across the SMs), the register leaf in place, and a panel solve
below it; a block of one panel is the leaf alone.  The leaf takes at most
K3_REG_MAX_B columns, so a w above it runs as panels of its largest
divisor up to K3_REG_MAX_B: the same L in exact arithmetic.  K4's and
K5's workspace (a diagonal block's inverse) comes from torch's allocator.

Dispatch is by the device of the tensor alone, as in se_tile.py.  A CUDA
tensor launches the kernel (float32 or float64) or raises; a CPU tensor
runs the plain version (`chol_inv_plain`, `cholesky_block_plain`,
`cholesky_panel_plain`): gp_tpu's loops in torch ops, on the live part of
the matrix only, which the tests hold against gp_tpu's kernels in
interpret mode and chip_smoke.py holds the kernels against on the card.
`launches[entry]` counts calls of each C entry point (K3: chol_inv_reg
or chol_inv; K4: chol; K5: chol_panel) that launched their kernels: one
per wrapper call on a CUDA tensor, however many kernels the entry
launches (K4's blocked form 3 ceil(b / K4_PANEL) - 1, K5 3 b / w' - 1
at panel width w' < b), and nothing else.

Failure contract, gp_tpu's: a non-positive pivot gives NaN in that column
and every later one.  Each input is read as a symmetric matrix (the
kernels read its lower triangle).

Gradients: a call that autograd records goes through a
torch.autograd.Function whose backward is gp_tpu's Murray pullback
`_chol_bwd` (pallas_chol.py:284-291); K3 first folds the T cotangent in,
Lbar - T^T Tbar T^T (:259-266).  Any other call (the blocked
factorization's leaves) launches directly: the Function's host overhead
is paid 64 times per factorization at N = 8000.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches since the last reset, by C entry point
launches = dict.fromkeys(("chol_inv_reg", "chol_inv", "chol", "chol_panel"),
                         0)

# the largest block K3's register kernel takes (its 128 x 128 square);
# K4 takes the same kernel up to it
K3_REG_MAX_B = 128

# K4's panel width above K3_REG_MAX_B: a copy of NB in csrc/chol_block.cu,
# which is compiled in (why 64: the comment there).  It sizes the
# workspace; changing it here changes nothing else.
K4_PANEL = 64


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def k3_entry(b: int) -> str:
    """The C entry of the K3 kernel a CUDA block of size b launches."""
    return "chol_inv_reg" if b <= K3_REG_MAX_B else "chol_inv"


_ENTRY = {"cholesky_block": "chol", "cholesky_panel": "chol_panel"}
_P, _I = ctypes.c_void_p, ctypes.c_int64
# (k, ldk, outputs or output and workspace, b[, w], stream)
_ARGTYPES = {"chol_inv": [_P, _I, _P, _P, _I, _P],
             "cholesky_block": [_P, _I, _P, _P, _I, _P],
             "cholesky_panel": [_P, _I, _P, _P, _I, _I, _P]}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _kernel_fn(entry: str, wrapper: str, dtype):
    """The C entry point `entry` (one of `wrapper`'s kernels) for dtype,
    from the library built at first use."""
    fn = getattr(_build.load("chol_block"), f"{entry}_{_SUFFIX[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[wrapper]
        fn.restype = ctypes.c_int
    return fn


def _check(wrapper: str, K) -> int:
    if K.ndim != 2 or K.shape[0] != K.shape[1]:
        raise ValueError(f"{wrapper}: K must be square (b, b); got "
                         f"{tuple(K.shape)}")
    return K.shape[0]


def _check_w(b: int, w: int) -> None:
    if w <= 0 or b % w:
        raise ValueError(f"cholesky_panel: the panel width w={w} must "
                         f"divide the block size b={b}")


def _launch(wrapper: str, K, *extra):
    """One call of `wrapper`'s C entry on K, which launches its kernels;
    returns its outputs.  K may be a block of a larger matrix: rows of
    unit stride are read in place (the entry takes the row stride),
    anything else is copied first.  `extra` goes to the entry after b
    (K5's w)."""
    if K.dtype not in _SUFFIX:
        raise TypeError(f"{wrapper}: the CUDA kernel takes float32 or "
                        f"float64, not {K.dtype}")
    b = K.shape[0]
    if K.stride(1) != 1 or K.stride(0) < b:
        K = K.contiguous()
    outs = [torch.empty((b, b), dtype=K.dtype, device=K.device)
            for _ in range(2 if wrapper == "chol_inv" else 1)]
    if b == 0:
        return outs
    entry = k3_entry(b) if wrapper == "chol_inv" else _ENTRY[wrapper]
    fn = _kernel_fn(entry, wrapper, K.dtype)
    ptrs = [o.data_ptr() for o in outs]
    if wrapper != "chol_inv":
        # K4's and K5's second buffer is their panels' workspace: T_pp, a
        # diagonal block's inverse (none where one leaf takes the block)
        if wrapper == "cholesky_block":
            side, one_leaf = K4_PANEL, K3_REG_MAX_B
        else:
            side = one_leaf = min(extra[0], K3_REG_MAX_B)
        ws = (torch.empty((side, side), dtype=K.dtype, device=K.device)
              if b > one_leaf else None)
        ptrs.append(None if ws is None else ws.data_ptr())
    with torch.cuda.device(K.device):
        rc = fn(K.data_ptr(), K.stride(0), *ptrs, b, *extra,
                torch.cuda.current_stream(K.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{wrapper}: chol_block launch (b={b}) failed "
                           f"with CUDA error {rc}")
    launches[entry] += 1
    return outs


# --------------------------------------------------------------------------
# Plain versions (gp_tpu's loops, pallas_chol.py)
# --------------------------------------------------------------------------

def chol_inv_plain(K):
    """(L, L^-1) by gp_tpu's fused rank-1 loop (pallas_chol.py:194-227):
    step j scales column j by rsqrt(d), subtracts l l^T from the trailing
    block, and finalizes row j of T, pushing T[i, :] -= l_i T[j, :] into
    the rows below."""
    b = _check("chol_inv", K)
    A = K.clone()
    L = torch.zeros_like(K)
    T = torch.eye(b, dtype=K.dtype, device=K.device)
    for j in range(b):
        d = A[j, j]
        inv = torch.rsqrt(d)
        lb = A[j + 1:, j] * inv
        L[j, j] = d * inv
        L[j + 1:, j] = lb
        A[j + 1:, j + 1:] -= torch.outer(lb, lb)
        tj = T[j, :j + 1] * inv
        T[j + 1:, :j + 1] -= torch.outer(lb, tj)
        T[j, :j + 1] = tj
    return L, T


def cholesky_block_plain(K):
    """L by gp_tpu's right-looking rank-1 loop (pallas_chol.py:48-69)."""
    b = _check("cholesky_block", K)
    A = K.clone()
    L = torch.zeros_like(K)
    for j in range(b):
        d = A[j, j]
        inv = torch.rsqrt(d)
        lb = A[j + 1:, j] * inv
        L[j, j] = d * inv
        L[j + 1:, j] = lb
        A[j + 1:, j + 1:] -= torch.outer(lb, lb)
    return L


def cholesky_panel_plain(K, w: int = 128):
    """L by gp_tpu's left-looking rank-w micro-panels (pallas_chol.py:
    112-143): per panel the GEMM C = K[:, p:p+w] - L L[p:p+w, :]^T (rows
    >= p; L's columns >= p are still zero), then the w-step rank-1 loop
    on the panel, which reads the pivot row of C."""
    b = _check("cholesky_panel", K)
    _check_w(b, w)
    L = torch.zeros_like(K)
    for p in range(0, b, w):
        C = K[p:, p:p + w] - L[p:, :p] @ L[p:p + w, :p].T
        for c in range(w):
            d = C[c, c]
            inv = torch.rsqrt(d)
            lb = C[c + 1:, c] * inv
            u = C[c, c + 1:].clone()
            C[c + 1:, c + 1:] -= torch.outer(lb * inv, u)
            C[:c, c] = 0.0
            C[c, c] = d * inv
            C[c + 1:, c] = lb
        L[p:, p:p + w] = C
    return L


# --------------------------------------------------------------------------
# Gradients
# --------------------------------------------------------------------------

def _chol_bwd(L, Lbar):
    """gp_tpu's _chol_bwd: Kbar = 0.5 L^-T (P + P^T) L^-1, P = Phi(L^T
    Lbar) (lower triangle, diagonal halved)."""
    P = torch.tril(L.T @ Lbar)
    P = P - 0.5 * torch.diag(torch.diagonal(P))
    S = P + P.T
    T1 = torch.linalg.solve_triangular(L.T, S, upper=True)     # L^-T S
    return 0.5 * torch.linalg.solve_triangular(L.T, T1.T, upper=True).T


def _dispatch(wrapper: str, plain, K, *extra):
    _check(wrapper, K)
    if K.device.type == "cpu":
        out = plain(K, *extra)
        return out if isinstance(out, tuple) else (out,)
    return tuple(_launch(wrapper, K, *extra))


class _CholInv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K):
        L, T = _dispatch("chol_inv", chol_inv_plain, K)
        ctx.save_for_backward(L, T)
        return L, T

    @staticmethod
    def backward(ctx, Lbar, Tbar):
        L, T = ctx.saved_tensors
        if Lbar is None:
            Lbar = torch.zeros_like(L)
        if Tbar is not None:
            Lbar = Lbar - T.T @ (Tbar @ T.T)
        return _chol_bwd(L, Lbar)


class _Chol(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K):
        L, = _dispatch("cholesky_block", cholesky_block_plain, K)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        return _chol_bwd(ctx.saved_tensors[0], Lbar)


class _CholPanel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, w):
        L, = _dispatch("cholesky_panel", cholesky_panel_plain, K, w)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        return _chol_bwd(ctx.saved_tensors[0], Lbar), None


def _tracked(K) -> bool:
    """Whether autograd records a call on K; the blocked factorization's
    leaves are not, and skip the Function's overhead."""
    return K.requires_grad and torch.is_grad_enabled()


def chol_inv(K):
    """K3: (L, L^-1) of one block, one launch (pallas_chol_inv)."""
    if _tracked(K):
        return _CholInv.apply(K)
    return _dispatch("chol_inv", chol_inv_plain, K)


def cholesky_block(K):
    """K4: the lower Cholesky factor of one block (pallas_cholesky)."""
    if _tracked(K):
        return _Chol.apply(K)
    return _dispatch("cholesky_block", cholesky_block_plain, K)[0]


def cholesky_panel(K, w: int = 128):
    """K5: the lower Cholesky factor of one block by rank-w micro-panels
    (pallas_cholesky_panel); w must divide the block size.  On the card a
    w above K3_REG_MAX_B runs as panels of its largest divisor up to
    K3_REG_MAX_B (the leaf's limit): every boundary of w is one of them,
    so L is the same in exact arithmetic and only the rounding order
    inside a w-panel changes."""
    _check_w(_check("cholesky_panel", K), w)
    if _tracked(K):
        return _CholPanel.apply(K, int(w))
    return _dispatch("cholesky_panel", cholesky_panel_plain, K, int(w))[0]
