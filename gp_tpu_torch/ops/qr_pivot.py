"""Column-pivoted Householder QR, the reference's default solver
(counterpart of gp_tpu/ops/qr_pivot.py:27-91; reference:
MatrixSolverQR, Eigen's ColPivHouseholderQR, MatrixSolver.cpp:31-53).

torch has no pivoted QR, so gp_tpu's loop is ported step for step: the
same pivots (the first largest downdated column norm: torch.argmax and
jnp.argmax both return the first maximum, and rank-deficient K ties many
norms at 0), the same reflectors, sign convention and zero-column guard,
and the same norm downdate.  Three changes leave every value as it was:

  * gp_tpu permutes every column at each step (R[:, idx], an N^2 copy);
    here the two columns are swapped in place;
  * the rank-1 updates run in place and only over the block they change:
    the reflector is zero above row j, so R's rows < j and Q's columns
    < j are untouched, and R's columns < j change only below the
    diagonal, which the final triu drops;
  * the pivot index stays on the device (no host sync per step).

Dispatch is by the device, as the covariance builds': a CUDA tensor runs
the loop as csrc/qr_pivot.cu's host loop of five launches a step (the
torch loop's ~30 launches a step cost the host ~1 s a factorization at
N = 2000 on an H100, far more than the card's work), `launches["qr_pivot"]`
counting its C calls; a CPU tensor runs qr_pivot_plain, the torch loop,
which is also the kernel's yardstick on the card.

Exact ties (the columns of duplicated rows) are broken as gp_tpu breaks
them, by the first position, only if equal columns get equal arithmetic.
XLA's reductions give that; torch's CPU column sums, gemv and addr_ do
not (their vector lanes and tails round differently by column position).
So on the CPU the column norms and v^T R are sequential sums (cumsum over
rows) and the update is a separate product and subtraction.  Past the
numerical rank the downdated norms are rounding residues, and the order
of those last pivots is rounding's in either package.

The loop is sequential, O(N) latency-bound steps of O(N^2) work, as
gp_tpu's is; the Cholesky path stays the performance solver.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# C calls of the kernel since the last reset (each runs the n steps)
launches = {"qr_pivot": 0}
_FN = {torch.float32: "qr_pivot_f32", torch.float64: "qr_pivot_f64"}


def reset_launches() -> None:
    launches["qr_pivot"] = 0


def _steps(R, Q, perm, cn, seq: bool) -> None:
    """gp_tpu's loop body for j = 0..n-1, in place on R, Q, perm and cn.
    No host sync: every step's pivot stays on the device.  seq: the
    sequential sums (the CPU's), else reductions."""
    n = R.shape[0]
    ar = torch.arange(n, device=R.device)
    one = torch.ones((), dtype=R.dtype, device=R.device)
    for j in range(n):
        # pivot: the remaining column with the largest downdated norm
        p = torch.argmax(cn[j:]).reshape(1) + j
        a = torch.cat([ar[j:j + 1], p])
        b = a.flip(0)
        R.index_copy_(1, a, R.index_select(1, b))
        perm.index_copy_(0, a, perm.index_select(0, b))
        cn.index_copy_(0, a, cn.index_select(0, b))

        # Householder reflector of column j, rows j:
        v = R[j:, j].clone()
        normx = torch.sqrt(torch.sum(v * v))
        v[:1] += torch.where(v[0] >= 0, one, -one) * normx
        vnorm2 = torch.sum(v * v)
        # guard: a zero column gives the identity reflector
        pos = vnorm2 > 0
        scale = torch.where(pos, 2.0 / torch.where(pos, vnorm2, one),
                            torch.zeros_like(one))
        Rb, Qb = R[j:, j:], Q[:, j:]
        col = v[:, None]
        if seq:
            w = (col * Rb).cumsum(0)[-1] * scale
            Rb.sub_(col * w[None, :])
        else:
            w = torch.sum(col * Rb, dim=0) * scale
            Rb.addcmul_(col, w[None, :], value=-1.0)
        q = torch.sum(Qb * v[None, :], dim=1) * scale
        Qb.addcmul_(q[:, None], v[None, :], value=-1.0)

        # norm downdate for the remaining columns
        cn[j:] = torch.clamp(cn[j:] - R[j, j:] ** 2, min=0.0)


def _start(K):
    """(R, Q, perm, cn) at step 0."""
    n = K.shape[0]
    seq = K.device.type == "cpu"
    cn = (K * K).cumsum(0)[-1].clone() if seq else torch.sum(K * K, dim=0)
    return (K.clone(memory_format=torch.contiguous_format),
            torch.eye(n, dtype=K.dtype, device=K.device),
            torch.arange(n, device=K.device), cn)


def qr_pivot_plain(K):
    """qr_pivot as torch ops (the CPU's path, the card kernel's
    yardstick)."""
    R, Q, perm, cn = _start(K)
    _steps(R, Q, perm, cn, seq=K.device.type == "cpu")
    return Q, torch.triu(R), perm


def qr_pivot(K):
    """K = Q R P^T with column pivoting.  Returns (Q, R, perm), perm int64,
    mapping pivoted column position -> original column index (K[:, perm] =
    Q R).  A CUDA tensor runs the kernel (float32 or float64) or raises;
    a CPU tensor qr_pivot_plain."""
    if K.device.type != "cuda":
        return qr_pivot_plain(K)
    if K.dtype not in _FN:
        raise TypeError(f"qr_pivot: the CUDA kernel takes float32 or "
                        f"float64, not {K.dtype}")
    if K.ndim != 2 or K.shape[0] != K.shape[1]:
        raise ValueError(f"qr_pivot: K must be square; got {tuple(K.shape)}")
    n = K.shape[0]
    R, Q, perm, cn = _start(K)
    if n == 0:
        return Q, R, perm
    lib = _build.load("qr_pivot")
    words = lib.qr_pivot_ws_words
    words.argtypes, words.restype = [ctypes.c_int64], ctypes.c_int64
    ws = K.new_empty(words(n))
    fn = getattr(lib, _FN[K.dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(K.device):
        rc = fn(R.data_ptr(), Q.data_ptr(), perm.data_ptr(), cn.data_ptr(),
                ws.data_ptr(), n,
                torch.cuda.current_stream(K.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qr_pivot: launch failed with CUDA error {rc}")
    launches["qr_pivot"] += 1
    return Q, torch.triu(R), perm


def qrp_ok(R):
    """Eigen's isInvertible analog: every |R_ii| finite and above the
    relative threshold max |R_ii| n eps."""
    d = torch.abs(torch.diagonal(R))
    n = R.shape[-1]
    thresh = torch.max(d) * n * torch.finfo(R.dtype).eps
    return torch.all(torch.isfinite(d)) & torch.all(d > thresh)


def qrp_logabsdet(R):
    """logAbsDeterminant (MatrixSolver.cpp:46-49); |det P| = 1."""
    return torch.sum(torch.log(torch.abs(torch.diagonal(R))))


def qrp_solve(Q, R, perm, b):
    """Solve K x = b given K[:, perm] = Q R: x[perm] = R^-1 Q^T b."""
    vec = b.ndim == 1
    z = torch.linalg.solve_triangular(R, Q.T @ (b[:, None] if vec else b),
                                      upper=True)
    x = torch.empty_like(z).index_copy(0, perm.to(z.device), z)
    return x[:, 0] if vec else x
