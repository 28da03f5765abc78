"""Blocked dense Cholesky and inverse (counterpart of gp_tpu/ops/blocked.py).

The factorization is right-looking with block panels: the O(N^3) work is
large GEMMs (the trailing updates, the panel products against the
diagonal blocks' inverses, the strips of `tri_inv_from_diag` and the
lauum-style `spd_inv_from_chol`), and what stays serial is the base case
of each diagonal block.  That base case, at m <= base_block with no
base_fn, is K3 (`chol_block.chol_inv`): (L, L^-1) of the block in one
launch.  ops/chol.py routes 2-D CUDA factorizations from
chol._BLOCKED_MIN_N rows here; on that route chol.factor_and_inverse
gives the objective (models/exact.py) its factor and inverse from here.

What differs from gp_tpu, and why:
- gp_tpu's leaf is K3 only behind GP_TPU_PALLAS_LEAF=1 (blocked.py:38-56);
  that switch is not carried.  The port's dispatch rule is that a CUDA
  tensor always takes the hand-written kernel, so the leaf is K3 whenever
  no base_fn is given (on the CPU, K3's plain version).
- gp_tpu starts the factorization from K.T, a layout hint for XLA
  (blocked.py:182-192).  Here it starts from a copy of K, so the base
  cases read the lower triangle; with zero_upper=False the strictly-upper
  leftovers are K's upper-triangle values.  K must still be symmetric: K5
  reads the upper entries of its w x w diagonal squares, as gp_tpu's does.
- The trailing update is written in place (`addmm_` on the trailing
  square): no new N^2 buffer per panel.
- The stock base case (n <= base_block, or block % base_block) is the
  library factor, `chol.library_cholesky`.
- The library inverse stays, as `spd_inv_library`, for the unblocked
  route; `spd_inv_from_chol` is gp_tpu's blocked lauum.
- Not carried: the blocked triangular solves (blocked.py:237-288); the
  solves stay library calls (cuBLAS trsm, LAPACK).  The column slabs
  (ops/slabbed.py) and the far-pad decoy rows exist for XLA:TPU's int32
  buffer addressing and pad costs and are not carried either.
"""

from __future__ import annotations

import torch

from . import chol_block


def add_diag(K, c):
    """K + c I, in place on K's diagonal (O(N)); returns K."""
    K.diagonal(dim1=-2, dim2=-1).add_(c)
    return K


def spd_inv_library(L):
    """K^-1 from K = L L^T by one library call (`torch.cholesky_inverse`):
    the unblocked route's inverse.  A NaN factor gives a NaN inverse,
    which the objective's sanitizer turns into INF."""
    return torch.cholesky_inverse(L)


def eye_pad(A, p: int):
    """blockdiag(A, I_p)."""
    n = A.shape[0]
    Ap = A.new_zeros((n + p, n + p))
    Ap[:n, :n] = A
    Ap.diagonal()[n:] = 1.0
    return Ap


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def _eye_like(A, m: int):
    return torch.eye(m, dtype=A.dtype, device=A.device)


def _chol_inv_block(Kb, block: int, base_block: int, base_fn,
                    need_inv: bool = True):
    """(L, T = L^-1) of one diagonal block, fused: the recursion's
    sub-block inverses serve both the panel GEMMs and the assembly of T
    (gp_tpu blocked.py:59-121).  The leaf (m <= base_block) is K3 when no
    base_fn is given, else base_fn followed by a triangular solve.
    need_inv=False (the caller's last panel) skips T.  The returned L
    holds Kb leftovers above its diagonal blocks; callers take its lower
    triangle."""
    m = Kb.shape[0]
    if m <= base_block:
        if base_fn is None:
            L, T = chol_block.chol_inv(Kb)
            return L, (T if need_inv else None)
        L = base_fn(Kb)
        if not need_inv:
            return L, None
        return L, _solve_lower(L, _eye_like(Kb, m))
    # gp_tpu's split rule: quarter-size panels, rounded down to a
    # base_block multiple
    b = max(base_block, min(block, m // 4))
    b -= b % base_block
    if m % b:
        # non-dividing size: the unfused pair
        L = blocked_cholesky(Kb, block=b, base_block=base_block,
                             base_fn=base_fn)
        return L, (tri_inv(L, base=base_block) if need_inv else None)
    nb = m // b
    L = Kb.clone()
    T = Kb.new_zeros((m, m)) if need_inv else None
    for j in range(nb):
        c0, c1 = j * b, (j + 1) * b
        last = c1 == m
        Ljj, Tjj = _chol_inv_block(L[c0:c1, c0:c1], b, base_block, base_fn,
                                   need_inv=need_inv or not last)
        L[c0:c1, c0:c1] = torch.tril(Ljj)
        if not last:
            pan = ut_matmul(L[c1:, c0:c1], Tjj.T)
            L[c1:, c0:c1] = pan
            L[c1:, c1:].addmm_(pan, pan.T, alpha=-1.0)
        if need_inv:
            if c0:
                # tri_inv's strip forward substitution, interleaved
                S = lt_matmul(L[c0:c1, :c0], T[:c0, :c0])
                T[c0:c1, :c0] = -(Tjj @ S)
            T[c0:c1, c0:c1] = Tjj
    return L, T


def blocked_cholesky(K, block: int = 1024, base_block: int = 128,
                     zero_upper: bool = True, base_fn=None,
                     return_diag_inv: bool = False):
    """Lower Cholesky factor of K (n x n), right-looking with block panels
    (gp_tpu blocked.py:124-222).  K is not modified.

    K must be symmetric.  Each diagonal block recurses down to
    `base_block` (`_chol_inv_block`), whose leaf is K3 unless base_fn (a
    function of one block, e.g. chol_block.cholesky_block or
    cholesky_panel) is given.  Sizes that are not multiples of `block` are
    factored as blockdiag(K, I) and sliced back; n <= base_block, or a
    block that is not a base_block multiple, takes the library factor.

    Each panel's triangular solve is a GEMM against the diagonal block's
    inverse (gp_tpu's panel_inv=True, the only form carried: nothing in
    the port solves the panels).  zero_upper=False leaves K leftovers in
    the strictly-upper triangle (the lower-triangle readers, i.e. the
    logdet, tri_inv_from_diag and spd_inv_from_chol, do not see them).
    return_diag_inv=True also returns the per-panel diagonal-block
    inverses Td (nb, block, block), (L, None) on the library fallback;
    aligned n only.

    NaN contract: a failing leaf is NaN from its failing pivot on, and
    the NaN reaches every later panel through the trailing updates."""
    from .chol import library_cholesky

    n = K.shape[0]
    if return_diag_inv:
        assert n % block == 0, "return_diag_inv requires aligned n"
    if n <= base_block or block % base_block:
        L = (base_fn or library_cholesky)(K)
        return (L, None) if return_diag_inv else L
    if n % block:
        return blocked_cholesky(eye_pad(K, block - n % block), block,
                                base_block, zero_upper, base_fn)[:n, :n]

    nb = n // block
    L = K.clone()
    diag_invs = []
    for j in range(nb):
        c0, c1 = j * block, (j + 1) * block
        Ljj, Tjj = _chol_inv_block(L[c0:c1, c0:c1], block, base_block,
                                   base_fn,
                                   need_inv=return_diag_inv or c1 < n)
        if return_diag_inv:
            diag_invs.append(Tjj)
        L[c0:c1, c0:c1] = torch.tril(Ljj)
        if c1 < n:
            pan = ut_matmul(L[c1:, c0:c1], Tjj.T)
            L[c1:, c0:c1] = pan
            L[c1:, c1:].addmm_(pan, pan.T, alpha=-1.0)
            if zero_upper:
                L[c0:c1, c1:] = 0.0
    if return_diag_inv:
        return L, torch.stack(diag_invs)
    return L


def lt_matmul(A, T, cutoff: int = 2048):
    """A @ T for lower-triangular T (m x m), splitting T recursively down
    to `cutoff` (gp_tpu blocked.py:291-308):
    [[T11, 0], [T21, T22]] -> [A1 T11 + A2 T21, A2 T22]."""
    m = T.shape[0]
    if m <= cutoff:
        return A @ T
    h = m // 2
    out_l = lt_matmul(A[:, :h], T[:h, :h], cutoff) + A[:, h:] @ T[h:, :h]
    out_r = lt_matmul(A[:, h:], T[h:, h:], cutoff)
    return torch.cat([out_l, out_r], dim=1)


def ut_matmul(A, U, cutoff: int = 2048):
    """A @ U for upper-triangular U (m x m); mirror of lt_matmul."""
    m = U.shape[0]
    if m <= cutoff:
        return A @ U
    h = m // 2
    out_l = ut_matmul(A[:, :h], U[:h, :h], cutoff)
    out_r = A[:, :h] @ U[:h, h:] + ut_matmul(A[:, h:], U[h:, h:], cutoff)
    return torch.cat([out_l, out_r], dim=1)


def _strips(L, Td, base: int, cutoff: int):
    """T = L^-1 from the diagonal-block inverses Td (nb, base, base): per
    block row k, the strip T[k, :c0] = -Td[k] (L[k, :c0] T[:c0, :c0])."""
    n = L.shape[0]
    T = L.new_zeros((n, n))
    T[:base, :base] = Td[0]
    for k in range(1, n // base):
        c0, c1 = k * base, (k + 1) * base
        S = lt_matmul(L[c0:c1, :c0], T[:c0, :c0], cutoff)
        T[c0:c1, :c0] = -(Td[k] @ S)
        T[c0:c1, c0:c1] = Td[k]
    return T


def tri_inv(L, base: int = 512, cutoff: int = 2048):
    """Inverse of a lower-triangular L (gp_tpu blocked.py:325-369): the
    diagonal base blocks in one batched triangular solve, then the strip
    forward substitution.  Reads only the lower triangle."""
    n = L.shape[0]
    if n <= base:
        return _solve_lower(L, _eye_like(L, n))
    if n % base:
        return tri_inv(eye_pad(L, base - n % base), base)[:n, :n]
    dblocks = torch.stack([L[k * base:(k + 1) * base,
                             k * base:(k + 1) * base]
                           for k in range(n // base)])
    Td = _solve_lower(dblocks, _eye_like(L, base).expand_as(dblocks))
    return _strips(L, Td, base, cutoff)


def tri_inv_from_diag(L, Td, block: int, cutoff: int = 2048):
    """L^-1 given the per-panel diagonal-block inverses Td (nb, block,
    block) from blocked_cholesky(return_diag_inv=True) (gp_tpu
    blocked.py:372-388)."""
    n = L.shape[0]
    nb = n // block
    assert nb * block == n and tuple(Td.shape) == (nb, block, block)
    return _strips(L, Td, block, cutoff)


def spd_inv_from_chol(L, block: int = 1024, base: int = 512,
                      diag_inv=None):
    """K^-1 from K = L L^T as T^T T with T = L^-1, lauum-style (gp_tpu
    blocked.py:391-431): block row i of K^-1 is one (b x n-c0) @
    (n-c0 x c0) GEMM plus a b x b diagonal product, written with its
    transpose.  diag_inv: Td from blocked_cholesky(return_diag_inv=True),
    which skips tri_inv's diagonal inversion; aligned n only.  Reads only
    L's lower triangle."""
    n = L.shape[0]
    if n < block:
        T = tri_inv(L, base)
        return T.T @ T
    if n % block:
        return spd_inv_from_chol(eye_pad(L, block - n % block), block,
                                 base)[:n, :n]
    T = (tri_inv_from_diag(L, diag_inv, block) if diag_inv is not None
         else tri_inv(L, base))
    A = L.new_zeros((n, n))
    for i in range(n // block):
        c0, c1 = i * block, (i + 1) * block
        R = T[c0:, c0:c1]
        if c0:
            S = R.T @ T[c0:, :c0]
            A[c0:c1, :c0] = S
            A[:c0, c0:c1] = S.T
        A[c0:c1, c0:c1] = R.T @ R
    return A
