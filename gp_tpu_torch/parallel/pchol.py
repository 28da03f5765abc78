"""Distributed blocked Cholesky and triangular solves over a process group
(counterpart of gp_tpu/parallel/pchol.py:41-415).

The N x N kernel matrix is block-row sharded BLOCK-CYCLICALLY over the
mesh axis "rows", and a right-looking blocked Cholesky runs as each
process's own program:

  panel j:  the owner factors the B x B diagonal block and broadcasts it
            every process right-solves its local panel rows (TRSM)
            the panel is all-gathered (N x B per step)
            the trailing update is one local GEMM per process

gp_tpu's G-layout is kept: a (N, ...) array in G-layout has shape
(nbl, P, B, ...), entry [l, q] holding row-block g = l P + q, and process
p holds [:, p], the blocks {g : g mod P == p}, as (nbl, B, ...).

Every function ending in `_local` is one process's program: its
arguments are this process's shards and `axis` (mesh.axis("rows"), a
parallel.mesh.Axis) names the group, as gp_tpu's run inside shard_map
with an axis_name.  The collectives map as

  jax.lax.psum                   all_reduce (SUM)
  jax.lax.all_gather             all_gather_into_tensor (rank order is
                                 gp_tpu's [q, l] layout)
  jax.lax.psum_scatter (tiled)   reduce_scatter_tensor
  the owner's psum of a block    broadcast from the owner (the same
  zero-masked elsewhere          values, NaN included)

and the look-ahead issues panel j + 1's all-gather asynchronously
(async_op=True) before panel j's wide trailing GEMM, and waits for it
after.  NCCL and gloo give every process the same all_reduce result, so
every replicated value (and any host branch on one) agrees across
processes.

The diagonal blocks are factored as gp_tpu factors them, by the library
(`chol.library_cholesky`: cholesky_ex, a failed block NaN in its whole
lower triangle, never an exception), not by a Pallas kernel.  The panel
solves, GEMMs and collectives are library calls.

Not carried: `max_safe_n` and `check_shard_addressable` (XLA:TPU's
2^30-element in-place update bound; torch indexes in int64), and
`blocked_layout`/`unblocked_layout`'s jax arrays (here `g_layout`,
`natural_layout` reshape tensors), and `pchol_local`'s lookahead=False
sequential loop (the look-ahead gives each entry the same arithmetic, so
the port runs it alone; tests hold its factor to gp_tpu's).  Loops over panels are Python loops
as gp_tpu's are unrolled: every slice is static and the trailing update
shrinks with j.
"""

from __future__ import annotations

import contextlib
import warnings

import torch
import torch.distributed as dist

from ..ops.chol import library_cholesky


# --------------------------------------------------------------------------
# Layout helpers
# --------------------------------------------------------------------------

def g_layout(a, n_dev: int, block: int):
    """(N, ...) -> G-layout (nbl, P, B, ...): [l, q] = row-block l P + q
    (gp_tpu's blocked_layout)."""
    n = a.shape[0]
    nb = n // block
    if nb % n_dev or n != nb * block:
        raise ValueError(f"N={n} must be a multiple of n_dev*block="
                         f"{n_dev * block}")
    return a.reshape(nb // n_dev, n_dev, block, *a.shape[1:])


def natural_layout(a):
    """G-layout (nbl, P, B, ...) -> natural (N, ...) (gp_tpu's
    unblocked_layout)."""
    nbl, p, b = a.shape[:3]
    return a.reshape(nbl * p * b, *a.shape[3:])


def pad_amount(n: int, n_dev: int, block: int) -> int:
    return (-n) % (n_dev * block)


def auto_block(n: int, n_dev: int, max_panels: int = 28,
               min_block: int = 256) -> int:
    """gp_tpu's panel width: nb = N / (P B) at most max_panels, a multiple
    of min_block.  gp_tpu bounds the panels to bound XLA's compile time;
    the formula is kept because the block fixes the layout a checkpoint
    records (dist_block)."""
    b = -(-n // (n_dev * max_panels))
    return max(min_block, -(-b // min_block) * min_block)


def local_blocks(nbl: int, axis, device) -> torch.Tensor:
    """Global block indices g = l P + p of this process's blocks."""
    return torch.arange(nbl, device=device) * axis.size + axis.index


def local_rows(a, axis):
    """This process's G-layout rows (nbl, B, ...) of a (nbl, P, B, ...)
    array."""
    return a[:, axis.index]


# --------------------------------------------------------------------------
# Collectives
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _quiet():
    """torch >= 2.13 marks all_gather_into_tensor and reduce_scatter_tensor
    deprecated (for all_gather_single, reduce_scatter_single, which older
    releases lack): the warning is silenced, the call kept."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        yield


def psum(t, axis):
    """all_reduce (SUM) of a copy of t over the axis."""
    t = t.clone()
    dist.all_reduce(t, group=axis.group)
    return t


def _all_gather(t, axis, async_op: bool = False):
    """(P, *t.shape), entry q from the axis' process q."""
    t = t.contiguous().reshape((-1,) + tuple(t.shape[1:]))
    # concatenated along dim 0 (gloo takes no stacked output), then viewed
    out = t.new_empty((axis.size * t.shape[0],) + tuple(t.shape[1:]))
    with _quiet():
        work = dist.all_gather_into_tensor(out, t, group=axis.group,
                                           async_op=async_op)
    out = out.view((axis.size,) + tuple(t.shape))
    return (out, work) if async_op else out


def all_gather_rows(t, axis):
    """This process's G-layout rows (nbl, B, ...) gathered to the natural
    (N, ...) order on every process."""
    full = _all_gather(t, axis)                     # [q, l] = block l P + q
    return natural_layout(full.transpose(0, 1))


def psum_scatter(part, axis):
    """reduce_scatter over dim 0 (tiled): the sum over the axis, process p
    keeping rows [p m, (p + 1) m) of the (P m, ...) sum."""
    out = part.new_empty((part.shape[0] // axis.size,)
                         + tuple(part.shape[1:]))
    with _quiet():
        dist.reduce_scatter_tensor(out, part.contiguous(), group=axis.group)
    return out


def broadcast_from(t, owner: int, axis):
    """t as the axis' process `owner` holds it, on every process.  The
    collective sends memory as it lies, so t is made contiguous first (a
    LAPACK solve returns its result column-major)."""
    t = t.contiguous()
    dist.broadcast(t, src=axis.ranks[owner], group=axis.group)
    return t


# --------------------------------------------------------------------------
# Per-process programs
# --------------------------------------------------------------------------

def _below(g, j: int):
    return (g > j)[:, None, None]


def _pchol_panel(K_loc, j: int, n_dev: int, axis):
    """Steps 1-2 of panel j: the owner factors the diagonal block and
    broadcasts it; the local panel TRSM, masked to the blocks below j.
    Returns the (nbl, B, B) panel (columns [j B, (j + 1) B))."""
    nbl, B, _ = K_loc.shape
    g = local_blocks(nbl, axis, K_loc.device)
    lj, owner = divmod(j, n_dev)
    c0, c1 = j * B, (j + 1) * B
    if axis.index == owner:
        Ljj = library_cholesky(K_loc[lj, :, c0:c1])
    else:
        Ljj = K_loc.new_empty((B, B))
    Ljj = broadcast_from(Ljj, owner, axis)
    # X = K[:, j] Ljj^-T for the blocks below j
    X = torch.linalg.solve_triangular(
        Ljj.T, K_loc[:, :, c0:c1].reshape(nbl * B, B), upper=True,
        left=False).reshape(nbl, B, B)
    panel = torch.where(_below(g, j), X, torch.zeros_like(X))
    return torch.where((g == j)[:, None, None], torch.tril(Ljj)[None], panel)


def _trailing(K_loc, panel, full, l0: int, c_lo: int, c_hi: int):
    """K_loc[l0:, :, c_lo:c_hi] -= panel[l0:] full[c_lo:c_hi]^T, one GEMM
    into the (nbl - l0) B rows."""
    nbl, B, N = K_loc.shape
    if l0 >= nbl or c_lo >= c_hi:
        return
    K2 = K_loc.view(nbl * B, N)
    K2[l0 * B:, c_lo:c_hi].addmm_(panel[l0:].reshape(-1, B),
                                  full[c_lo:c_hi].T, alpha=-1.0)


def pchol_local(K_loc, n_dev: int, axis):
    """Distributed right-looking blocked Cholesky, in place.

    K_loc: (nbl, B, N), this process's row blocks of the SPD matrix
    (block g = l P + p, columns in natural order).  Returns L_loc in the
    same layout, exactly lower-triangular (the panel writes store zeros
    above the diagonal, and no later step touches those columns).  A
    non-SPD input shows as NaN in the factor's diagonal (chol_ok
    semantics).  Local blocks l < (j + 1) // P have g <= j on every
    process, so the trailing GEMM starts at l0 (N^3 / 3 in all).

    With a one-panel look-ahead: the update with panel j is split into
    the narrow slice that finalizes panel j + 1's columns (applied first)
    and the wide remainder; panel j + 1 is then factored, and its
    all-gather issued asynchronously before the wide GEMM, so the two
    overlap.  Each output entry gets the same arithmetic as in the plain
    sequential loop (gp_tpu's lookahead=False, not carried)."""
    nbl, B, N = K_loc.shape
    nb = nbl * n_dev

    def step(j):
        panel = _pchol_panel(K_loc, j, n_dev, axis)
        K_loc[:, :, j * B:(j + 1) * B] = panel
        return panel

    panel = step(0)
    full = all_gather_rows(panel, axis)
    for j in range(nb - 1):
        c1, c2 = (j + 1) * B, (j + 2) * B
        l0 = (j + 1) // n_dev
        # (a) narrow update: finalize panel j + 1's own columns
        _trailing(K_loc, panel, full, l0, c1, c2)
        # (b) factor panel j + 1 and issue its all-gather now
        panel_next = step(j + 1)
        gathered, work = _all_gather(panel_next, axis, async_op=True)
        # (c) the wide remainder, behind the gather
        _trailing(K_loc, panel, full, l0, c2, N)
        work.wait()
        panel, full = panel_next, natural_layout(gathered.transpose(0, 1))
    return K_loc


def _diag_entries(L_loc, axis):
    """(nbl, B) diagonal entries of this process's blocks."""
    nbl, B, N = L_loc.shape
    g = local_blocks(nbl, axis, L_loc.device)
    cols = g[:, None] * B + torch.arange(B, device=L_loc.device)[None, :]
    return torch.gather(L_loc, 2, cols[:, :, None])[:, :, 0]


def plogdet_local(L_loc, n_dev: int, axis):
    """log|K| = 2 sum log diag(L), reduced over the axis."""
    return psum(2.0 * torch.sum(torch.log(_diag_entries(L_loc, axis))), axis)


def ptrsm_lower_local(L_loc, R_loc, n_dev: int, axis):
    """Solve L W = R, both row-sharded in G-layout: L_loc (nbl, B, N), R_loc
    (nbl, B, T).  Per panel the owner solves its B x T block and
    broadcasts it, and every process updates its rows below the panel
    with one GEMM (N^2 T / 2P work each, N T traffic in all)."""
    nbl, B, N = L_loc.shape
    nb = nbl * n_dev
    g = local_blocks(nbl, axis, L_loc.device)
    W = R_loc.clone()
    for j in range(nb):
        lj, owner = divmod(j, n_dev)
        c0, c1 = j * B, (j + 1) * B
        if axis.index == owner:
            wj = torch.linalg.solve_triangular(L_loc[lj, :, c0:c1], W[lj],
                                               upper=False)
        else:
            wj = W.new_empty(W.shape[1:])
        wj = broadcast_from(wj, owner, axis)
        if axis.index == owner:
            W[lj] = wj
        l0 = (j + 1) // n_dev
        if l0 < nbl:
            upd = torch.matmul(L_loc[l0:, :, c0:c1], wj)
            W[l0:] -= torch.where(_below(g[l0:], j), upd,
                                  torch.zeros_like(upd))
    return W


def pinv_rows_local(L_loc, n_dev: int, axis):
    """W = L^-1, row-sharded G-layout (nbl, B, N): the forward TRSM with
    the identity's rows, which touches only columns < (j + 1) B at panel j
    (W is lower-triangular): ~N^3 / 6P flops, and each broadcast (B, c1)."""
    nbl, B, N = L_loc.shape
    nb = nbl * n_dev
    dev = L_loc.device
    g = local_blocks(nbl, axis, dev)
    W = torch.zeros_like(L_loc)
    # the running right-hand side: this process's rows of I
    rows = g[:, None] * B + torch.arange(B, device=dev)[None, :]
    R = (rows[:, :, None] == torch.arange(N, device=dev)).to(L_loc.dtype)
    for j in range(nb):
        lj, owner = divmod(j, n_dev)
        c0, c1 = j * B, (j + 1) * B
        if axis.index == owner:
            wj = torch.linalg.solve_triangular(L_loc[lj, :, c0:c1],
                                               R[lj, :, :c1], upper=False)
        else:
            wj = L_loc.new_empty((B, c1))
        wj = broadcast_from(wj, owner, axis)
        if axis.index == owner:
            W[lj, :, :c1] = wj
        l0 = (j + 1) // n_dev
        if l0 < nbl:
            upd = torch.matmul(L_loc[l0:, :, c0:c1], wj)
            R[l0:, :, :c1] -= torch.where(_below(g[l0:], j), upd,
                                          torch.zeros_like(upd))
    return W


def ptrsm_lowerT_local(L_loc, R_loc, n_dev: int, axis):
    """Solve L^T X = R, row-sharded G-layout (back substitution from the
    last panel): each process sums L[g, j]^T x_g over its blocks g > j,
    the sums are reduced, and the owner solves and broadcasts."""
    nbl, B, N = L_loc.shape
    nb = nbl * n_dev
    T = R_loc.shape[-1]
    g = local_blocks(nbl, axis, L_loc.device)
    X = torch.zeros_like(R_loc)
    Xfull = R_loc.new_zeros((nb, B, T))          # the solved blocks, by g
    for j in range(nb - 1, -1, -1):
        lj, owner = divmod(j, n_dev)
        c0, c1 = j * B, (j + 1) * B
        l0 = (j + 1) // n_dev
        if l0 >= nbl:
            part = R_loc.new_zeros((B, T))
        else:
            Lj = torch.where(_below(g[l0:], j), L_loc[l0:, :, c0:c1],
                             torch.zeros((), dtype=L_loc.dtype,
                                         device=L_loc.device))
            part = torch.einsum("lkr,lkt->rt", Lj, Xfull[g[l0:]])
        acc = psum(part, axis)
        if axis.index == owner:
            xj = torch.linalg.solve_triangular(L_loc[lj, :, c0:c1].T,
                                               R_loc[lj] - acc, upper=True)
        else:
            xj = R_loc.new_empty((B, T))
        xj = broadcast_from(xj, owner, axis)
        if axis.index == owner:
            X[lj] = xj
        Xfull[j] = xj
    return X


def pchol_solve_local(L_loc, R_loc, n_dev: int, axis):
    """Solve (L L^T) X = R, row-sharded G-layout."""
    Z = ptrsm_lower_local(L_loc, R_loc, n_dev, axis)
    return ptrsm_lowerT_local(L_loc, Z, n_dev, axis)


def pinv_from_chol_local(L_loc, n_dev: int, axis):
    """K^-1 = L^-T L^-1, row-sharded G-layout (nbl, B, N): W = L^-1 by the
    TRSM with the identity's rows, then per output row block the sum over
    processes of W[:, :, g cols]^T W, kept by the block's owner (O(N^3 / P)
    work, O(N^2) traffic, never an N x N on one process)."""
    nbl, B, N = L_loc.shape
    nb = nbl * n_dev
    dev = L_loc.device
    g = local_blocks(nbl, axis, dev)
    rows = g[:, None] * B + torch.arange(B, device=dev)[None, :]
    eye_rows = (rows[:, :, None] == torch.arange(N, device=dev)
                ).to(L_loc.dtype)
    W = ptrsm_lower_local(L_loc, eye_rows, n_dev, axis)
    Kinv = torch.zeros_like(L_loc)
    Wf = W.reshape(nbl * B, N)
    for gi in range(nb):
        lj, owner = divmod(gi, n_dev)
        part = Wf[:, gi * B:(gi + 1) * B].T @ Wf              # (B, N)
        full = psum(part, axis)
        if axis.index == owner:
            Kinv[lj] = full
    return Kinv


def pkinv_rowblock_local(W, l: int, n_dev: int, axis):
    """This process's K^-1 rows of its local block l, from the row-sharded
    W = L^-1 (pinv_rows_local): the rows of global blocks {l P + q : q} are
    the column slice W[:, :, l P B:(l + 1) P B] contracted against W, one
    local GEMM, and one reduce-scatter sums the parts over processes and
    hands each its own (B, N) block.  W is exactly lower-triangular, so
    the contraction starts at local block l (rows g < l P are zero in the
    slice)."""
    nbl, B, N = W.shape
    cs = l * n_dev * B
    part = (W[l:, :, cs:cs + n_dev * B].reshape(-1, n_dev * B).T
            @ W[l:].reshape(-1, N))
    return psum_scatter(part, axis)
