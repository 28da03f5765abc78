"""The 2-D block-cyclic distributed Cholesky and the exact GP on it
(counterpart of gp_tpu/parallel/pchol2d.py:68-751).

The 1-D layout (parallel/pchol.py) all-gathers each (N, B) panel to
every process, ~4 N^2 bytes per process and evaluation, all of it across
the host boundary once the "rows" ring spans hosts.  Here the block grid
is 2-D (ScaLAPACK's pdpotrf layout): global block (i, j) lives on the
process at grid position (i mod Pr, j mod Pc) of a ("rowg", "colg") mesh
(mesh.make_mesh_grid).  At panel k each process needs only the panel's
blocks of its own grid row (left operands) and of its own grid column
(right operands):

    row broadcast, along "colg" from the panel's grid column:  N B / Pr
    column exchange, a sum along "rowg" (one contributor a slot): N B / Pc

With each host on its own grid row (multihost.global_mesh_2d), only the
column exchange crosses hosts.

Layout.  A process holds its tiles (nbr, nbc, B, B), tile [li, lj] the
global block (li Pr + r, lj Pc + c), gp_tpu's local layout; the port
stores them as one (nbr B, nbc B) matrix, and the 4-D tensor is a view of
it (`tiles`, `flat`), so that a trailing update or a SUMMA step is one
GEMM into a slice.  The global layout (Pr, Pc, nbr, nbc, B, B) of a
checkpoint is gp_tpu's (blocked_layout_2d).

Every `_local` function is one process's program and takes `grid`, the
Grid of its mesh (`grid_of(mesh)`: Pr, Pc, this process's (r, c) as
Python integers and the three groups).  gp_tpu masks with traced grid
coordinates; the port slices statically instead: a panel's TRSM, its
broadcasts and the trailing update cover exactly the blocks with global
index past k, and the SUMMA steps of K^-1 exactly the blocks at or before
it (gp_tpu's masked blocks are exact zeros, so the values are the same).
gp_tpu's psums of masked values map as

  one contributor (a replicated block)    dist.broadcast from the owner
  the column exchange                     all_reduce over "rowg" (sum)
  a reduction over the grid               all_reduce over mesh.whole

NCCL and gloo give every member of a group the same all_reduce result,
so each replicated value, and each host branch on one, agrees across
processes.  The diagonal blocks are factored by the library
(chol.library_cholesky: cholesky_ex, a failed block NaN in its lower
triangle), as gp_tpu's jnp.linalg.cholesky factors them and the 1-D
pchol does; a NaN pivot propagates into every later panel, so the
rescue ladder's probe works unchanged.

K2 on this path (se_tile<T, FORM, false, VEC> on a CUDA tensor, gp_tpu's
seard_k_pallas -> _se_tile_kernel): an NLL+gradient evaluation launches
it twice, once for the build of the process's (nbr B, nbc B) tiles and
once for their rebuild under autograd (the vjp's forward; its backward
is torch ops); a value evaluation or a posterior attempt once; a batch
prediction once, its input gradients once more.

One host-driven `pfit2d` on the port's L-BFGS-B (every process runs the
same optimizer on the same replicated values, as pgp.pfit) replaces
gp_tpu's pfit2d_hosted and multihost.pfit2d.  Not carried: the jitted
program wrappers (jax.jit/shard_map plumbing) and
check_shard_addressable (XLA:TPU's int32 bound; torch indexes in int64).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.base import (from_opt_vec, hyp_mean, hyp_sn2,
                           sanitize_value_and_grad)
from ..ops.chol import library_cholesky
from ..ops.kernels import KernelSpec
from ..optim.lbfgsb import LBFGSBResult, lbfgsb_impl
from .pchol import auto_block, broadcast_from, psum

AXR, AXC = "rowg", "colg"


class Grid(NamedTuple):
    """One process's view of a ("rowg", "colg") mesh."""
    pr: int
    pc: int
    r: int                  # this process's grid row
    c: int                  # and column
    rowg: object            # Axis down its grid column (index r)
    colg: object            # Axis along its grid row (index c)
    whole: object           # Axis over the whole grid


def grid_of(mesh) -> Grid:
    rg, cg = mesh.axis(AXR), mesh.axis(AXC)
    return Grid(rg.size, cg.size, rg.index, cg.index, rg, cg, mesh.whole)


# --------------------------------------------------------------------------
# Layout helpers
# --------------------------------------------------------------------------

def blocked_layout_2d(K, pr: int, pc: int, block: int):
    """(N, N) -> (Pr, Pc, nbr, nbc, B, B): [r, c, li, lj] = global block
    (li Pr + r, lj Pc + c).  numpy or torch."""
    n = K.shape[0]
    nb = n // block
    if nb * block != n or nb % pr or nb % pc:
        raise ValueError(f"N={n} must tile into nb blocks of {block} with "
                         f"Pr={pr} | nb and Pc={pc} | nb (nb={nb})")
    K6 = K.reshape(nb // pr, pr, block, nb // pc, pc, block)
    return K6.transpose(1, 4, 0, 3, 2, 5) if isinstance(K, np.ndarray) \
        else K6.permute(1, 4, 0, 3, 2, 5)


def unblocked_layout_2d(Kb):
    """Inverse of blocked_layout_2d (numpy)."""
    pr, pc, nbr, nbc, B = Kb.shape[:5]
    return np.asarray(Kb).transpose(2, 0, 4, 3, 1, 5).reshape(
        nbr * pr * B, nbc * pc * B)


def pad_amount(n: int, pr: int, pc: int, block: int) -> int:
    """Rows to append so N tiles into block multiples of lcm(Pr, Pc)."""
    return (-n) % (block * math.lcm(pr, pc))


def tiles(a, block: int):
    """The (nbr, nbc, B, B) tile view of a (nbr B, nbc B) matrix."""
    nr, nc = a.shape[0] // block, a.shape[1] // block
    return a.view(nr, block, nc, block).permute(0, 2, 1, 3)


def flat(t):
    """(nbr, nbc, B, B) tiles as one (nbr B, nbc B) matrix: a view of the
    storage when t is `tiles` of a contiguous matrix, else a copy."""
    nbr, nbc, B, _ = t.shape
    return t.permute(0, 2, 1, 3).reshape(nbr * B, nbc * B)


def local_tiles(Lg, r: int, c: int):
    """This process's tiles of a global (Pr, Pc, nbr, nbc, B, B) array
    (numpy), as the tile view of a contiguous matrix (torch)."""
    B = Lg.shape[4]
    a = np.ascontiguousarray(np.asarray(Lg)[r, c].transpose(0, 2, 1, 3))
    return tiles(torch.from_numpy(a.reshape(a.shape[0] * B, -1)), B)


def _n_le(k: int, idx: int, p: int) -> int:
    """How many local blocks l have global index l p + idx <= k."""
    return max(0, (k - idx) // p + 1)


def _grid_ids(nbr: int, nbc: int, grid: Grid):
    """(global row-block ids, global column-block ids), Python lists."""
    return ([li * grid.pr + grid.r for li in range(nbr)],
            [lj * grid.pc + grid.c for lj in range(nbc)])


def _replicate_from(val, owner_r: int, owner_c: int, grid: Grid):
    """`val` as the (owner_r, owner_c) process holds it, on every process
    of the grid (val's shape and dtype on every process)."""
    return broadcast_from(val, owner_r * grid.pc + owner_c, grid.whole)


# --------------------------------------------------------------------------
# Per-process programs
# --------------------------------------------------------------------------

def _panel(Kf, k: int, B: int, grid: Grid):
    """Grid panel k on the flat tiles Kf, in place: the diagonal block
    factored by its owner and sent down its grid column, that column's
    TRSM X[i] = K[i, k] Lkk^-T (i > k) written back with Lkk's tile
    tril'd, and the row broadcast of X along "colg", issued
    asynchronously.  Returns a function that waits for it, makes the
    column exchange and returns (prow, pcol): L[i, k] for this process's
    row blocks i > k ((nbr - lo) B, B) and L[j, k] for its column blocks
    j > k ((nbc - cl) B, B)."""
    pr, pc, r, c = grid.pr, grid.pc, grid.r, grid.c
    nbr, nbc = Kf.shape[0] // B, Kf.shape[1] // B
    orow, oc = k % pr, k % pc
    li, lj = k // pr, k // pc
    lo, cl = _n_le(k, r, pr), _n_le(k, c, pc)
    c0, c1 = lj * B, (lj + 1) * B
    if c == oc:
        if r == orow:
            Lkk = library_cholesky(Kf[li * B:(li + 1) * B, c0:c1])
        else:
            Lkk = Kf.new_empty((B, B))
        Lkk = broadcast_from(Lkk, orow, grid.rowg)
        prow = torch.linalg.solve_triangular(
            Lkk.T, Kf[lo * B:, c0:c1], upper=True, left=False).contiguous()
        Kf[lo * B:, c0:c1] = prow
        if r == orow:
            Kf[li * B:(li + 1) * B, c0:c1] = torch.tril(Lkk)
    else:
        prow = Kf.new_empty(((nbr - lo) * B, B))
    work = (dist.broadcast(prow, src=grid.colg.ranks[oc],
                           group=grid.colg.group, async_op=True)
            if prow.numel() else None)

    def finish():
        if work is not None:
            work.wait()
        # L[j, k] lies in grid row j mod Pr, slot (j - r') / Pr of its
        # prow: one contributor a slot, summed along "rowg"
        pcol = Kf.new_zeros(((nbc - cl) * B, B))
        if not pcol.numel():
            return prow, pcol
        mine = [(m, (j - r) // pr - lo) for m, j in
                enumerate(range(cl * pc + c, nbc * pc, pc)) if j % pr == r]
        if mine:
            dst, src = zip(*mine)
            pcol.view(-1, B, B)[list(dst)] = prow.view(-1, B, B)[list(src)]
        dist.all_reduce(pcol, group=grid.rowg.group)
        return prow, pcol
    return finish


def _update(Kf, prow, pcol, B: int, lo: int, c_lo: int, c_hi: int,
            cl: int) -> None:
    """Kf[lo B:, c_lo B:c_hi B] -= prow pcol[c_lo - cl .. c_hi - cl]^T,
    one GEMM (pcol's rows start at local column block cl)."""
    if prow.shape[0] == 0 or c_lo >= c_hi:
        return
    Kf[lo * B:, c_lo * B:c_hi * B].addmm_(
        prow, pcol[(c_lo - cl) * B:(c_hi - cl) * B].T, alpha=-1.0)


def pchol2d_local(K_loc, grid: Grid, lookahead: bool = True):
    """Right-looking blocked Cholesky on the 2-D block-cyclic layout.

    K_loc: (nbr, nbc, B, B), this process's tiles; factored in place when
    it is the `tiles` view of a contiguous matrix (as _build_k_local
    returns it).  Returns L in the same layout: diagonal tiles tril'd,
    tiles above the diagonal untouched (consumers read the lower triangle
    only, as gp_tpu's).

    The update with panel k is two GEMMs: the narrow slice that finalizes
    panel k + 1's own column (on the grid column that holds it), then the
    wide remainder.  With lookahead=True panel k + 1 is factored and its
    row broadcast issued between the two, and waited for after the wide
    GEMM, so the broadcast runs behind it; lookahead=False runs the
    sequential schedule.  Each entry gets the same arithmetic in both, so
    the factors are bitwise equal (gp_tpu's lookahead flag and test)."""
    nbr, nbc, B, _ = K_loc.shape
    pr, pc, r, c = grid.pr, grid.pc, grid.r, grid.c
    Kf = flat(K_loc)
    prow, pcol = _panel(Kf, 0, B, grid)()
    for k in range(nbr * pr - 1):
        lo, cl = _n_le(k, r, pr), _n_le(k, c, pc)
        cn = cl + (1 if (k + 1) % pc == c and cl < nbc else 0)
        _update(Kf, prow, pcol, B, lo, cl, cn, cl)
        if lookahead:
            finish = _panel(Kf, k + 1, B, grid)
            _update(Kf, prow, pcol, B, lo, cn, nbc, cl)
        else:
            _update(Kf, prow, pcol, B, lo, cn, nbc, cl)
            finish = _panel(Kf, k + 1, B, grid)
        prow, pcol = finish()
    return tiles(Kf, B)


def _diag_tiles(nbr: int, nbc: int, grid: Grid):
    """(k, li, lj) of this process's diagonal tiles."""
    return [(k, k // grid.pr, k // grid.pc)
            for k in range(grid.r, nbr * grid.pr, grid.pr)
            if k % grid.pc == grid.c and k // grid.pc < nbc]


def plogdet2d_local(L_loc, grid: Grid):
    """log|K| = 2 sum log diag(L) over the grid (replicated)."""
    nbr, nbc, B, _ = L_loc.shape
    s = L_loc.new_zeros(())
    for _, li, lj in _diag_tiles(nbr, nbc, grid):
        s = s + torch.sum(torch.log(torch.diagonal(L_loc[li, lj])))
    return psum(2.0 * s, grid.whole)


def _as_cols(rhs):
    return (rhs[:, None], True) if rhs.ndim == 1 else (rhs, False)


def psolve2d_lower_local(L_loc, rhs, grid: Grid):
    """Solve L W = rhs with rhs (N_pad,) or (N_pad, T) replicated; W
    replicated in rhs's shape.  Row k of L lies on grid row k mod Pr: per
    panel that row sums its part over "colg", the owner solves, and the
    block is broadcast to the grid (O(B T) a panel)."""
    nbr, nbc, B, _ = L_loc.shape
    pr, pc, r, c = grid.pr, grid.pc, grid.r, grid.c
    Lf = flat(L_loc)
    R, vec = _as_cols(rhs)
    T = R.shape[1]
    nb = nbr * pr
    w = torch.zeros_like(R).view(nb, B, T)
    _, gj = _grid_ids(nbr, nbc, grid)
    for k in range(nb):
        orow, oc, li = k % pr, k % pc, k // pr
        if r == orow:
            cb = _n_le(k - 1, c, pc)                 # my blocks j < k
            part = Lf[li * B:(li + 1) * B, :cb * B] @ \
                w[gj[:cb]].reshape(cb * B, T)
            dist.all_reduce(part, group=grid.colg.group)
            if c == oc:
                lj = k // pc
                wk = torch.linalg.solve_triangular(
                    torch.tril(Lf[li * B:(li + 1) * B, lj * B:(lj + 1) * B]),
                    R[k * B:(k + 1) * B] - part, upper=False)
            else:
                wk = R.new_empty((B, T))
        else:
            wk = R.new_empty((B, T))
        w[k] = _replicate_from(wk, orow, oc, grid)
    w = w.view(nb * B, T)
    return w[:, 0] if vec else w


def psolve2d_lower_t_local(L_loc, rhs, grid: Grid):
    """Solve L^T X = rhs (back substitution), rhs (N_pad,) or (N_pad, T)
    replicated.  Column k of L lies on grid column k mod Pc: per panel
    that column sums its part over "rowg", the owner solves, and the
    block is broadcast to the grid."""
    nbr, nbc, B, _ = L_loc.shape
    pr, pc, r, c = grid.pr, grid.pc, grid.r, grid.c
    Lf = flat(L_loc)
    R, vec = _as_cols(rhs)
    T = R.shape[1]
    nb = nbr * pr
    x = torch.zeros_like(R).view(nb, B, T)
    gi, _ = _grid_ids(nbr, nbc, grid)
    for k in range(nb - 1, -1, -1):
        orow, oc, lj = k % pr, k % pc, k // pc
        if c == oc:
            lo = _n_le(k, r, pr)                     # my blocks i > k
            part = Lf[lo * B:, lj * B:(lj + 1) * B].T @ \
                x[gi[lo:]].reshape((nbr - lo) * B, T)
            dist.all_reduce(part, group=grid.rowg.group)
            if r == orow:
                li = k // pr
                xk = torch.linalg.solve_triangular(
                    torch.tril(Lf[li * B:(li + 1) * B,
                                  lj * B:(lj + 1) * B]).T,
                    R[k * B:(k + 1) * B] - part, upper=True)
            else:
                xk = R.new_empty((B, T))
        else:
            xk = R.new_empty((B, T))
        x[k] = _replicate_from(xk, orow, oc, grid)
    x = x.view(nb * B, T)
    return x[:, 0] if vec else x


def pinv2d_local(L_loc, grid: Grid):
    """W = L^-1 on the grid, in gp_tpu's tile layout: the forward TRSM
    with the identity's rows.  At panel k the running right-hand side's
    row k lies on grid row k mod Pr, which solves it against Lkk (sent
    along that row); the update R[i, j] -= L[i, k] W[k, j] takes L[i, k]
    from the panel's grid column (along "colg") and W[k, j] from the
    panel's grid row (along "rowg").  W overwrites R in one buffer (row k
    of R is final at panel k, and the update touches only rows past k);
    only the blocks j <= k of row k are nonzero, ~N^3 / 3P update flops."""
    nbr, nbc, B, _ = L_loc.shape
    pr, pc, r, c = grid.pr, grid.pc, grid.r, grid.c
    Lf = flat(L_loc)
    Wf = Lf.new_zeros(Lf.shape)
    ri, ci, _ = _diag_index(nbr, nbc, grid, B, Lf.device)
    Wf[ri, ci] = 1.0
    for k in range(nbr * pr):
        orow, oc, li, lj = k % pr, k % pc, k // pr, k // pc
        ce, lo = _n_le(k, c, pc), _n_le(k, r, pr)   # j <= k; i > k
        rows = slice(li * B, (li + 1) * B)
        if r == orow:
            Lkk = (torch.tril(Lf[rows, lj * B:(lj + 1) * B]) if c == oc
                   else Lf.new_empty((B, B)))
            Lkk = broadcast_from(Lkk, oc, grid.colg)
            if ce:
                Wf[rows, :ce * B] = torch.linalg.solve_triangular(
                    Lkk, Wf[rows, :ce * B], upper=False)
        if ce:
            wk = (Wf[rows, :ce * B] if r == orow
                  else Wf.new_empty((B, ce * B)))
            wk = broadcast_from(wk, orow, grid.rowg)
        if lo < nbr:
            Lcol = (Lf[lo * B:, lj * B:(lj + 1) * B] if c == oc
                    else Lf.new_empty(((nbr - lo) * B, B)))
            Lcol = broadcast_from(Lcol, oc, grid.colg)
            if ce:
                Wf[lo * B:, :ce * B].addmm_(Lcol, wk, alpha=-1.0)
    return tiles(Wf, B)


def pkinv2d_local(W_loc, grid: Grid):
    """K^-1 tiles = W^T W on the grid, SUMMA over W's block rows.  At step
    k, W's row k reaches each process in two hops: along "rowg" from grid
    row k mod Pr (the blocks of its own grid columns, the right operand),
    then a sum along "colg" of the blocks of its own grid rows (one
    contributor a slot, the left operand).  W[k, i] is zero for i > k, so
    step k adds into the corner of blocks i, j <= k only: ~2 N^3 / 3P
    flops, one rank-B GEMM a step."""
    nbr, nbc, B, _ = W_loc.shape
    pr, pc, r, c = grid.pr, grid.pc, grid.r, grid.c
    Wf = flat(W_loc)
    Kinv = Wf.new_zeros(Wf.shape)
    for k in range(nbr * pr):
        orow, li = k % pr, k // pr
        ce, re = _n_le(k, c, pc), _n_le(k, r, pr)   # j <= k; i <= k
        # hop 1: W[k, j] for my column blocks j <= k
        if ce:
            wj = (Wf[li * B:(li + 1) * B, :ce * B] if r == orow
                  else Wf.new_empty((B, ce * B)))
            wj = broadcast_from(wj, orow, grid.rowg)
        if not re:
            continue
        # hop 2: W[k, i] for my row blocks i <= k, each from the process of
        # my grid row whose column holds block i
        wi = Wf.new_zeros((B, re * B))
        mine = [(m, (i - c) // pc) for m, i in
                enumerate(range(r, re * pr, pr)) if i % pc == c]
        if mine:
            dst, src = zip(*mine)
            wi.view(B, re, B)[:, list(dst)] = wj.view(B, ce, B)[:, list(src)]
        dist.all_reduce(wi, group=grid.colg.group)
        if ce:
            Kinv[:re * B, :ce * B].addmm_(wi.T, wj)
    return tiles(Kinv, B)


def _diag_index(nbr: int, nbc: int, grid: Grid, B: int, device):
    """(local rows, local columns, global ids) of the diagonal entries in
    this process's tiles."""
    ar = torch.arange(B, device=device)
    d = _diag_tiles(nbr, nbc, grid)
    if not d:
        e = torch.zeros(0, dtype=torch.long, device=device)
        return e, e, e
    k, li, lj = (torch.tensor(v, device=device)[:, None] for v in zip(*d))
    return ((li * B + ar).reshape(-1), (lj * B + ar).reshape(-1),
            (k * B + ar).reshape(-1))


def _mask_pads(A, row_ids, col_ids, n_real: int) -> None:
    """Zero the rows and columns of A past n_real, in place."""
    A.index_fill_(0, torch.nonzero(row_ids >= n_real)[:, 0], 0.0)
    A.index_fill_(1, torch.nonzero(col_ids >= n_real)[:, 0], 0.0)


@torch.no_grad()
def _build_k_local(kernel: KernelSpec, hyp, x_pad, n_real: int,
                   grid: Grid, block: int):
    """This process's tiles of K_pad = K + sn2 I (pad rows and columns
    the identity's), one K2 launch of (nbr B, nbc B); the tiles view of a
    contiguous matrix.  Returns (K_loc, row_ids, col_ids)."""
    n_pad = x_pad.shape[0]
    nbr, nbc = n_pad // (block * grid.pr), n_pad // (block * grid.pc)
    dev = x_pad.device
    gi, gj = _grid_ids(nbr, nbc, grid)
    ar = torch.arange(block, device=dev)
    row_ids = (torch.tensor(gi, device=dev)[:, None] * block + ar).reshape(-1)
    col_ids = (torch.tensor(gj, device=dev)[:, None] * block + ar).reshape(-1)
    nc = kernel.num_hyp(x_pad.shape[1])
    K = kernel.k(hyp[:nc], x_pad[row_ids], x_pad[col_ids])
    _mask_pads(K, row_ids, col_ids, n_real)
    ri, ci, ids = _diag_index(nbr, nbc, grid, block, dev)
    K[ri, ci] = torch.where(ids < n_real, K[ri, ci] + hyp_sn2(hyp),
                            torch.ones((), dtype=K.dtype, device=dev))
    return tiles(K, block), row_ids, col_ids


def _r_full(hyp, y_pad, n_real: int):
    return torch.where(torch.arange(y_pad.shape[0], device=y_pad.device)
                       < n_real, y_pad - hyp_mean(hyp),
                       torch.zeros_like(y_pad))


def pnll_vg2d_local(kernel: KernelSpec, hyp, x_pad, y_pad, n_real: int,
                    grid: Grid, block: int):
    """(NLL, dNLL/dhyp) on the grid, both replicated.  The gradient is
    gp_tpu's analytic assembly (GP.cpp:151-171): Q tiles = K^-1 tiles -
    alpha_i alpha_j^T (pinv2d, then the SUMMA pkinv2d), contracted by the
    vjp of this process's own tile build (no collective inside it); one
    all_reduce over the grid then sums the covariance gradient and
    tr(Q).  NaN/inf propagate (the caller sanitizes)."""
    nc = kernel.num_hyp(x_pad.shape[1])
    chyp = hyp[:nc]
    sn2 = hyp_sn2(hyp)
    K_loc, row_ids, col_ids = _build_k_local(kernel, hyp, x_pad, n_real,
                                             grid, block)
    L_loc = pchol2d_local(K_loc, grid)
    del K_loc
    L_shape = L_loc.shape
    w = psolve2d_lower_local(L_loc, _r_full(hyp, y_pad, n_real), grid)
    nll = (0.5 * torch.dot(w, w) + 0.5 * plogdet2d_local(L_loc, grid)
           + 0.5 * n_real * math.log(2 * math.pi))
    alpha = psolve2d_lower_t_local(L_loc, w, grid)          # replicated
    W_loc = pinv2d_local(L_loc, grid)
    del L_loc
    Q = flat(pkinv2d_local(W_loc, grid))
    del W_loc
    Q.addr_(alpha[row_ids], alpha[col_ids], alpha=-1.0)
    # the pads are constants of the build: zero cotangent
    _mask_pads(Q, row_ids, col_ids, n_real)
    ri, ci, _ = _diag_index(L_shape[0], L_shape[1], grid, block, Q.device)
    tr_loc = torch.sum(Q[ri, ci])
    ch = chyp.detach().requires_grad_(True)
    with torch.enable_grad():
        k = kernel.k(ch, x_pad[row_ids], x_pad[col_ids])
    gc, = torch.autograd.grad(k, ch, Q)
    del k, Q
    red = psum(torch.cat([gc, tr_loc[None]]), grid.whole)
    g_mean = -torch.sum(alpha[:n_real])
    grad = torch.cat([0.5 * red[:nc],
                      torch.stack([sn2 * red[nc], g_mean]).to(red.dtype)])
    return nll, grad


@torch.no_grad()
def pnll2d_local(kernel: KernelSpec, hyp, x_pad, y_pad, n_real: int,
                 grid: Grid, block: int):
    """The grid NLL value (GP.cpp:120-148; NaN/inf propagate)."""
    K_loc, _, _ = _build_k_local(kernel, hyp, x_pad, n_real, grid, block)
    L_loc = pchol2d_local(K_loc, grid)
    w = psolve2d_lower_local(L_loc, _r_full(hyp, y_pad, n_real), grid)
    return (0.5 * torch.dot(w, w) + 0.5 * plogdet2d_local(L_loc, grid)
            + 0.5 * n_real * math.log(2 * math.pi))


# --------------------------------------------------------------------------
# Entry points (every process of the grid calls each, with the same x, y)
# --------------------------------------------------------------------------

def _as(t, like):
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def _pad_xy(x, y, grid: Grid, block: int):
    n = x.shape[0]
    pad = pad_amount(n, grid.pr, grid.pc, block)
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
        y = torch.cat([y, y.new_zeros(pad)])
    return x, y, n


def _block(x, grid: Grid, block):
    return auto_block(x.shape[0], grid.pr * grid.pc) if block is None \
        else block


def pnll_vg2d(kernel: KernelSpec, hyp, x, y, mesh, block: int | None = None):
    """Distributed (NLL, grad) on the grid, INF-sanitized: pgp.pnll_vg's
    grid twin.  block=None takes pchol.auto_block over Pr Pc processes."""
    grid = grid_of(mesh)
    block = _block(x, grid, block)
    x_pad, y_pad, n = _pad_xy(x, y, grid, block)
    f, g = pnll_vg2d_local(kernel, _as(hyp, x), x_pad, y_pad, n, grid,
                           block)
    return sanitize_value_and_grad(f, g)


def pnll2d(kernel: KernelSpec, hyp, x, y, mesh, block: int | None = None):
    """Distributed exact-GP NLL on the grid, INF-sanitized."""
    grid = grid_of(mesh)
    block = _block(x, grid, block)
    x_pad, y_pad, n = _pad_xy(x, y, grid, block)
    f = pnll2d_local(kernel, _as(hyp, x), x_pad, y_pad, n, grid, block)
    return sanitize_value_and_grad(f, f.new_zeros(1))[0]


def pfit2d(kernel: KernelSpec, noise_free: bool, x, y, vec0, lb, ub, mesh,
           block: int | None = None, max_evals: int = 160) -> LBFGSBResult:
    """Bounded MLE fit on the grid: lbfgsb_impl on every process, each
    evaluation one pnll_vg2d (gp_tpu's pfit2d_hosted and multihost.pfit2d;
    the port's optimizer runs on the host either way).  Pass standardized
    targets (or use GP.train_distributed)."""
    grid = grid_of(mesh)
    block = _block(x, grid, block)
    x_pad, y_pad, n = _pad_xy(x, y, grid, block)

    def fun(v):
        hyp = from_opt_vec(v, noise_free)
        f, g = pnll_vg2d_local(kernel, hyp, x_pad, y_pad, n, grid, block)
        gv = torch.cat([g[:-2], g[-1:]]) if noise_free else g
        return sanitize_value_and_grad(f, gv)

    vec0, lb, ub = (_as(a, x) for a in (vec0, lb, ub))
    return lbfgsb_impl(fun, vec0, lb, ub, max_evals=max_evals)


@torch.no_grad()
def _pfactor2d(kernel, hyp, x_pad, y_pad, n_real, grid, block):
    """(L_loc, ok, invKys over N_pad) of K(hyp); ok is reduced over the
    whole grid before any host reads it.  The cached factor's tiles above
    the diagonal are zeroed (no consumer reads them): the factor is
    exactly lower-triangular, as the 1-D one is, and a checkpoint of it
    compresses as that one does."""
    K_loc, _, _ = _build_k_local(kernel, hyp, x_pad, n_real, grid, block)
    L_loc = pchol2d_local(K_loc, grid)
    nbr, nbc, B, _ = L_loc.shape
    gi, gj = (torch.tensor(v, device=L_loc.device)
              for v in _grid_ids(nbr, nbc, grid))
    L_loc[gi[:, None] < gj[None, :]] = 0.0
    ri, ci, _ = _diag_index(nbr, nbc, grid, B, L_loc.device)
    d = flat(L_loc)[ri, ci]
    bad = torch.sum(~(torch.isfinite(d) & (d > 0))).to(L_loc.dtype)
    bad = psum(bad, grid.whole)
    w = psolve2d_lower_local(L_loc, _r_full(hyp, y_pad, n_real), grid)
    invKys = psolve2d_lower_t_local(L_loc, w, grid)
    return L_loc, bool(bad == 0), invKys


def pset_k2d(kernel: KernelSpec, hyp, x, y, mesh, block: int | None = None,
             max_tries: int = 32):
    """Grid posterior cache with the reference's noise-inflation rescue
    (GP::_setK, GP.cpp:423-444): while the grid Cholesky fails,
    log sigma_n += log sqrt(10) (from -inf: log eps); every attempt stays
    on the grid, and every process takes the same steps (ok is reduced).

    Returns (hyp', L_loc (nbr, nbc, B, B) this process's factor tiles,
    invKys (N,) replicated, ok); ok=False: every try failed, and L/invKys
    hold NaN (never cache them)."""
    grid = grid_of(mesh)
    block = _block(x, grid, block)
    x_pad, y_pad, n = _pad_xy(x, y, grid, block)
    hyp = _as(hyp, x).clone()
    eps = torch.finfo(x.dtype).eps
    log_sn = float(hyp[-2])
    ok = False
    for _ in range(max_tries):
        hyp[-2] = log_sn
        L, ok, invKys = _pfactor2d(kernel, hyp, x_pad, y_pad, n, grid,
                                   block)
        if ok:
            break
        log_sn = (math.log(eps) if math.isinf(log_sn)
                  else log_sn + 0.5 * math.log(10.0))
    hyp[-2] = log_sn
    return hyp, L, invKys[:n], ok


def _kt_pad(kt, n_pad: int):
    """(N_pad, T): kt^T over the real rows, zero on the pads."""
    out = kt.new_zeros((n_pad, kt.shape[0]))
    out[:kt.shape[1]] = kt.T
    return out


@torch.no_grad()
def ppredict2d(kernel: KernelSpec, hyp, x, L, invKys, xs, mesh):
    """Grid batch posterior (GP::_predict, GP.cpp:273-297): the mean from
    the cached invKys, the variance ||L^-1 k*||^2 by the grid's forward
    solve (O(N T) traffic).  L is this process's factor tiles."""
    grid = grid_of(mesh)
    hyp = _as(hyp, x)
    chyp = hyp[:kernel.num_hyp(x.shape[1])]
    xs = _as(xs, x)
    kt = kernel.k(chyp, xs, x)                                 # (T, N)
    mu = hyp_mean(hyp) + kt @ invKys
    n_pad = L.shape[0] * L.shape[2] * grid.pr
    Z = psolve2d_lower_local(L, _kt_pad(kt, n_pad), grid)
    quad = torch.sum(Z * Z, dim=0)
    s2 = torch.clamp(kernel.diag_k(chyp, xs) - quad, min=0.0) + hyp_sn2(hyp)
    return mu, s2


def ppredict2d_with_grad(kernel: KernelSpec, hyp, x, L, invKys, xs, mesh):
    """(y, gy, s2, gs2) off the grid posterior, the BO acquisition path
    (GP.cpp:284-296): gy = dk*/dx . invKys, gs2 = -2 dk*/dx . (K^-1 k*),
    the variance clamp out of the gradient; K^-1 k* by the grid's two
    solves, replicated."""
    grid = grid_of(mesh)
    hyp = _as(hyp, x)
    chyp = hyp[:kernel.num_hyp(x.shape[1])]
    xs = _as(xs, x)
    n = x.shape[0]
    with torch.no_grad():
        kt = kernel.k(chyp, xs, x)
        n_pad = L.shape[0] * L.shape[2] * grid.pr
        Z = psolve2d_lower_local(L, _kt_pad(kt, n_pad), grid)
        kks = psolve2d_lower_t_local(L, Z, grid)[:n]           # (N, T)
        s2 = torch.clamp(kernel.diag_k(chyp, xs)
                         - torch.einsum("tn,nt->t", kt, kks), min=0.0) \
            + hyp_sn2(hyp)
    xr = xs.detach().requires_grad_(True)
    with torch.enable_grad():
        kr = kernel.k(chyp, xr, x)
        y = hyp_mean(hyp) + kr @ invKys
        gy, gs2 = (torch.autograd.grad(kr, xr, w, retain_graph=True)[0]
                   for w in (invKys[None, :].expand_as(kr), -2.0 * kks.T))
    return y.detach(), gy, s2, gs2
