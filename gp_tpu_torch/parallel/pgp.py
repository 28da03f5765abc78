"""Distributed exact GP: the sharded NLL and its analytic gradient, the
fit, the posterior and the predictions (counterpart of
gp_tpu/parallel/pgp.py:56-497).

The N x N kernel matrix is row-sharded block-cyclically over the mesh
axis "rows" (layout and factorization: parallel/pchol.py), and every
process runs the same program on its shard.  The gradient is analytic
(GP.cpp:151-171), as gp_tpu's:

    Q      = K^-1 - alpha alpha^T
    g_covK = 0.5 sum(Q o dK/dtheta)   the vjp of this process's row-block
                                      build, per local block (K2's rows
                                      k(x_g, X) and their _CovK backward)
    g_sn   = sn2 tr(Q);  g_mean = -sum(alpha)

K^-1 is streamed: W = L^-1 by the distributed TRSM, then each local row
block of K^-1 comes from one sliced GEMM and a reduce-scatter
(pchol.pkinv_rowblock_local) and is contracted at once; ~2 N^2 / P live
per process.  The row-block builds are `kernel.k(chyp, x_rows, x_pad)`,
on a CUDA tensor K2 (se_tile<T, FORM, false, VEC>, gp_tpu's
seard_k_pallas -> _se_tile_kernel): one launch for the build, one per
local block in the gradient.

Padding: N is padded to a multiple of P B with identity rows and
columns (K_pad = blockdiag(K, I), r_pad = [r; 0]): log|K_pad| = log|K|
and alpha_pad = [alpha; 0], and the pads have zero cotangent.

One host-driven `pfit` on the port's L-BFGS-B (every process runs the
same optimizer on the same replicated values) replaces gp_tpu's jitted
`pfit` and host-driven `pfit_hosted`: the split and gp_tpu's
_DIST_HOSTED_WORK exist for XLA:TPU's execution watchdog.  Every value a
host branch reads here is the result of a collective (NCCL and gloo give
every process the same all_reduce result), so no two processes can take
different branches and deadlock the group.

Not carried: the jitted program wrappers (_pnll_program,
_pfactor_program, _pquad_program, _ppredict_program, _psolve_columns:
jax.jit/shard_map plumbing) and the int32 shard check (pchol).
"""

from __future__ import annotations

import math

import torch

from ..models.base import (from_opt_vec, hyp_mean, hyp_sn2,
                           sanitize_value_and_grad)
from ..ops.kernels import KernelSpec
from ..optim.lbfgsb import LBFGSBResult, lbfgsb_impl
from . import pchol
from .pchol import all_gather_rows, psum

AXIS = "rows"


# --------------------------------------------------------------------------
# Per-process pieces
# --------------------------------------------------------------------------

def _row_ids(nbl: int, block: int, axis, device):
    """(nbl, B) global row indices of this process's blocks."""
    g = pchol.local_blocks(nbl, axis, device)
    return g[:, None] * block + torch.arange(block, device=device)[None, :]


@torch.no_grad()
def _build_k_local(kernel: KernelSpec, chyp, x_pad, n_real: int,
                   block: int, axis, sn2=None):
    """This process's row blocks of K_pad: (nbl, B, N_pad), pad rows and
    columns the identity's, plus sn2 on the real diagonal when given; one
    K2 launch for all local rows.  Returns (K_loc, row_ids)."""
    n_pad = x_pad.shape[0]
    nbl = n_pad // (block * axis.size)
    rows = _row_ids(nbl, block, axis, x_pad.device)
    flat = rows.reshape(-1)
    K = kernel.k(chyp, x_pad[flat], x_pad).reshape(nbl * block, n_pad)
    K[:, n_real:] = 0.0
    pad_rows = flat >= n_real
    K[pad_rows] = 0.0
    i = torch.arange(flat.shape[0], device=x_pad.device)
    K[i[pad_rows], flat[pad_rows]] = 1.0
    if sn2 is not None:
        K[i[~pad_rows], flat[~pad_rows]] += sn2
    return K.reshape(nbl, block, n_pad), rows


def _local_r(y_pad, mean, n_real: int, rows):
    """(nbl, B, 1) this process's rows of r = y - mean, 0 on the pads."""
    r = y_pad - mean
    r = torch.where(torch.arange(y_pad.shape[0], device=y_pad.device)
                    < n_real, r, torch.zeros_like(r))
    return r[rows][..., None]


def pnll_vg_local(kernel: KernelSpec, hyp, x_pad, y_pad, n_real: int,
                  n_dev: int, block: int, axis):
    """(NLL, dNLL/dhyp) on this process's shard, both reduced over the
    axis (replicated).  NaN/inf propagate (GP.cpp:120-176)."""
    nc = kernel.num_hyp(x_pad.shape[1])
    chyp = hyp[:nc]
    sn2 = hyp_sn2(hyp)
    n_pad = x_pad.shape[0]
    nbl = n_pad // (block * n_dev)

    K_loc, rows = _build_k_local(kernel, chyp, x_pad, n_real, block, axis,
                                 sn2)
    L_loc = pchol.pchol_local(K_loc, n_dev, axis)
    del K_loc
    real = (rows < n_real).to(x_pad.dtype)
    r_loc = _local_r(y_pad, hyp_mean(hyp), n_real, rows)
    a_loc = pchol.pchol_solve_local(L_loc, r_loc, n_dev, axis)
    data_fit = 0.5 * psum(torch.sum(r_loc * a_loc), axis)
    logdet = pchol.plogdet_local(L_loc, n_dev, axis)
    nll = data_fit + 0.5 * logdet + 0.5 * n_real * math.log(2 * math.pi)

    # the streamed gradient: W = L^-1 is the only other N^2 / P buffer
    W = pchol.pinv_rows_local(L_loc, n_dev, axis)
    del L_loc
    a_full = all_gather_rows(a_loc[..., 0], axis)              # natural
    col_real = torch.arange(n_pad, device=x_pad.device) < n_real
    g_cov = torch.zeros_like(chyp)
    tr_loc = torch.zeros((), dtype=x_pad.dtype, device=x_pad.device)
    for l in range(nbl):
        kinv_g = pchol.pkinv_rowblock_local(W, l, n_dev, axis)   # (B, N)
        rid = rows[l]
        a_g = a_loc[l, :, 0]
        q = kinv_g - a_g[:, None] * a_full[None, :]
        # the pads are constants of the build: zero cotangent
        q = torch.where((rid[:, None] < n_real) & col_real[None, :], q,
                        torch.zeros_like(q))
        c = chyp.detach().requires_grad_(True)
        with torch.enable_grad():
            k_rows = kernel.k(c, x_pad[rid], x_pad)
        gc, = torch.autograd.grad(k_rows, c, q)
        g_cov = g_cov + 0.5 * gc
        diag_g = torch.gather(kinv_g, 1, rid[:, None])[:, 0]
        tr_loc = tr_loc + torch.sum(real[l] * (diag_g - a_g ** 2))
    red = psum(torch.cat([g_cov, torch.stack([tr_loc, torch.sum(a_loc)])]),
               axis)
    g_sn = sn2 * red[nc]
    g_mean = -red[nc + 1]
    grad = torch.cat([red[:nc], torch.stack([g_sn, g_mean]).to(red.dtype)])
    return nll, grad


# --------------------------------------------------------------------------
# Entry points (every process of the mesh calls each, with the same x, y)
# --------------------------------------------------------------------------

def _axis(mesh):
    return mesh.axis(AXIS)


def _as(t, like):
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def _pad_xy(x, y, n_dev: int, block: int):
    n = x.shape[0]
    pad = pchol.pad_amount(n, n_dev, block)
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))])
        y = torch.cat([y, y.new_zeros(pad)])
    return x, y, n


def _block(x, n_dev: int, block):
    return pchol.auto_block(x.shape[0], n_dev) if block is None else block


def pnll_vg(kernel: KernelSpec, hyp, x, y, mesh, block: int | None = None):
    """Distributed (NLL, grad) over the full hyp vector; INF-sanitized.
    block=None takes pchol.auto_block."""
    ax = _axis(mesh)
    block = _block(x, ax.size, block)
    x_pad, y_pad, n = _pad_xy(x, y, ax.size, block)
    f, g = pnll_vg_local(kernel, _as(hyp, x), x_pad, y_pad, n, ax.size,
                         block, ax)
    return sanitize_value_and_grad(f, g)


def _objective(kernel, noise_free, x_pad, y_pad, n, block, ax):
    def fun(v):
        hyp = from_opt_vec(v, noise_free)
        f, g = pnll_vg_local(kernel, hyp, x_pad, y_pad, n, ax.size, block,
                             ax)
        gv = torch.cat([g[:-2], g[-1:]]) if noise_free else g
        return sanitize_value_and_grad(f, gv)
    return fun


def pfit(kernel: KernelSpec, noise_free: bool, x, y, vec0, lb, ub, mesh,
         block: int | None = None, max_evals: int = 160,
         axis: str = AXIS) -> LBFGSBResult:
    """Distributed bounded MLE fit: lbfgsb_impl on every process, each
    objective evaluation factoring the block-cyclic K (pchol) and reducing
    the analytic gradient.  Pass standardized targets (or use
    GP.train_distributed), as gp_tpu's float32 note says."""
    ax = mesh.axis(axis)
    block = _block(x, ax.size, block)
    x_pad, y_pad, n = _pad_xy(x, y, ax.size, block)
    vec0, lb, ub = (_as(a, x) for a in (vec0, lb, ub))
    return lbfgsb_impl(_objective(kernel, noise_free, x_pad, y_pad, n, block,
                                  ax), vec0, lb, ub, max_evals=max_evals)


@torch.no_grad()
def _pfactor(kernel, hyp, x_pad, y_pad, n_real, block, ax):
    """(L_loc, ok, invKys over N_pad) of K(hyp); ok is replicated."""
    nc = kernel.num_hyp(x_pad.shape[1])
    K, rows = _build_k_local(kernel, hyp[:nc], x_pad, n_real, block, ax,
                             hyp_sn2(hyp))
    L = pchol.pchol_local(K, ax.size, ax)
    d = pchol._diag_entries(L, ax)
    bad = psum(torch.sum(~(torch.isfinite(d) & (d > 0))).to(d.dtype), ax)
    a = pchol.pchol_solve_local(
        L, _local_r(y_pad, hyp_mean(hyp), n_real, rows), ax.size, ax)
    return L, bool(bad == 0), all_gather_rows(a[..., 0], ax)


def pset_k(kernel: KernelSpec, hyp, x, y, mesh, block: int | None = None,
           max_tries: int = 32):
    """Distributed posterior cache with the reference's noise-inflation
    rescue (GP::_setK, GP.cpp:423-444): while the sharded Cholesky fails,
    log sigma_n += log sqrt(10) (from -inf: log eps).  Every process takes
    the same steps (ok is reduced).

    Returns (hyp', L_loc (nbl, B, N_pad) this process's factor rows,
    invKys (N,) replicated, ok); ok=False: every try failed, and L/invKys
    hold NaN (never cache them)."""
    ax = _axis(mesh)
    block = _block(x, ax.size, block)
    x_pad, y_pad, n = _pad_xy(x, y, ax.size, block)
    hyp = _as(hyp, x).clone()
    eps = torch.finfo(x.dtype).eps
    log_sn = float(hyp[-2])
    ok = False
    for _ in range(max_tries):
        hyp[-2] = log_sn
        L, ok, invKys = _pfactor(kernel, hyp, x_pad, y_pad, n, block, ax)
        if ok:
            break
        log_sn = (math.log(eps) if math.isinf(log_sn)
                  else log_sn + 0.5 * math.log(10.0))
    hyp[-2] = log_sn
    return hyp, L, invKys[:n], ok


def _kt_rows(kernel, chyp, xs, x, n_pad, block, ax):
    """(T, N) cross-covariance (one K2 launch) and this process's G-layout
    rows (nbl, B, T) of its transpose, zero on the pads."""
    kt = kernel.k(chyp, xs, x)
    kt_pad = kt.new_zeros((n_pad, xs.shape[0]))
    kt_pad[:x.shape[0]] = kt.T
    return kt, pchol.local_rows(pchol.g_layout(kt_pad, ax.size, block), ax)


@torch.no_grad()
def ppredict(kernel: KernelSpec, hyp, x, L, invKys, xs, mesh,
             block: int | None = None):
    """Distributed batch posterior (GP::_predict, GP.cpp:273-297): the mean
    from the cached invKys, the variance by the sharded solve.  L is this
    process's factor rows (nbl, B, N_pad); block defaults to its B."""
    ax = _axis(mesh)
    block = L.shape[1] if block is None else block
    hyp = _as(hyp, x)
    chyp = hyp[:kernel.num_hyp(x.shape[1])]
    kt, ktb = _kt_rows(kernel, chyp, _as(xs, x), x, L.shape[2], block, ax)
    mu = hyp_mean(hyp) + kt @ invKys
    kks = pchol.pchol_solve_local(L, ktb, ax.size, ax)
    quad = psum(torch.einsum("lbt,lbt->t", ktb, kks), ax)
    s2 = torch.clamp(kernel.diag_k(chyp, xs) - quad, min=0.0) + hyp_sn2(hyp)
    return mu, s2


def ppredict_with_grad(kernel: KernelSpec, hyp, x, L, invKys, xs, mesh,
                       block: int | None = None):
    """(y, gy, s2, gs2) off the sharded posterior, the BO acquisition path
    (GP.cpp:284-296): gy = dk*/dx . invKys, gs2 = -2 dk*/dx . (K^-1 k*),
    the variance clamp out of the gradient.  Each test point's row depends
    on it alone, so one autograd pass gives every point's gradient."""
    ax = _axis(mesh)
    block = L.shape[1] if block is None else block
    hyp = _as(hyp, x)
    chyp = hyp[:kernel.num_hyp(x.shape[1])]
    xs = _as(xs, x)
    with torch.no_grad():
        kt, ktb = _kt_rows(kernel, chyp, xs, x, L.shape[2], block, ax)
        kks = all_gather_rows(pchol.pchol_solve_local(L, ktb, ax.size, ax),
                              ax)[:x.shape[0]]                   # (N, T)
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


def pfit_multistart(kernel: KernelSpec, noise_free: bool, x, y, vec0s, lb,
                    ub, mesh, block: int | None = None, max_evals: int = 160):
    """Two-axis distributed multi-start MLE over a ("starts", "rows") mesh
    (mesh.make_mesh_2d): each "starts" slice runs its own start's L-BFGS-B
    with K block-cyclic over its "rows" group; one all-gather over
    "starts" then picks the best.  vec0s: (n_starts, n) starts, n_starts
    the mesh's "starts" size.  Returns (best_vec, best_f), replicated."""
    from .pmultistart import best_of
    st = mesh.axis("starts")
    vec0s = torch.as_tensor(vec0s)
    if vec0s.shape[0] != st.size:
        raise ValueError(f"need one start per 'starts' slice ({st.size}), "
                         f"got {vec0s.shape[0]}")
    res = pfit(kernel, noise_free, x, y, vec0s[st.index], lb, ub, mesh,
               block=block, max_evals=max_evals)
    x_best, _, all_f, _ = best_of(res.x[None], res.f.reshape(1), st)
    return x_best, torch.min(all_f)
