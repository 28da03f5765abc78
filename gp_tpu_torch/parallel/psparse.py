"""Distributed FITC / VFE: the training rows sharded over the mesh
(counterpart of gp_tpu/parallel/psparse.py:37-264).

The sparse objectives are sums over the N training rows of O(M) and
O(M^2) row-local terms plus replicated M x M algebra (models/fitc.py,
models/vfe.py): each process builds its (n_loc, M) cross-covariance
panel (K2) and the partial sums, and an all_reduce combines them; the
traffic per evaluation is a few M x M and M-vector sums, whatever N.
Rows are padded to a multiple of the mesh size with masked rows
(Kxu = 0, r = 0, Gamma = 1), which add exactly zero to every sum.

The sums run in gp_tpu's two rounds: the data fit is the sum over rows of
(Gamma^-1 r) . (r - Kxu A^-1 t1), which needs the first round's totals
(A, t1) first, so the values are gp_tpu's up to summation order.

The gradient.  gp_tpu takes jax.grad through the psum.  In torch,
torch.distributed.nn's all_reduce backpropagates by another all_reduce,
which, with every process holding the same replicated loss, makes the
gradient P times too large.  So the gradient is assembled by hand:

  1. each process computes its partial sums with autograd, from leaf
     copies of hyp, of the replicated factor Luu and of v = A^-1 (...),
     and all_reduces them as detached values;
  2. the replicated tail is differentiated to the totals (cotangents
     identical everywhere), and those cotangents are pushed through this
     process's partial sums (the second round's first, whose v-cotangent
     is all_reduced and joins the first round's);
  3. the local hyp and Luu gradients are all_reduced, and the replicated
     graph's own hyp gradient, with the summed v and Luu cotangents,
     completes it.

Not carried: the jitted program wrappers.
"""

from __future__ import annotations

import math

import torch

from ..models.base import (from_opt_vec, hyp_mean, hyp_sn2,
                           sanitize_value_and_grad)
from ..models.sparse import eye_like, zero_like
from ..ops.chol import (chol_logdet, chol_ok, chol_solve, library_cholesky,
                        solve_lower)
from ..ops.kernels import KernelSpec
from ..optim.lbfgsb import LBFGSBResult, lbfgsb_impl
from .pchol import psum

AXIS = "rows"


def _shard_rows(x, y, axis):
    """This process's contiguous slice of the rows padded to a multiple of
    the axis' size, and its mask (1 on real rows)."""
    n = x.shape[0]
    n_loc = -(-n // axis.size)
    lo = axis.index * n_loc
    idx = torch.arange(lo, lo + n_loc, device=x.device)
    real = idx < n
    idx = torch.where(real, idx, torch.zeros_like(idx))
    mask = real.to(x.dtype)
    return x[idx] * mask[:, None], y[idx] * mask, mask, n


# --------------------------------------------------------------------------
# FITC (FITC.cpp:201-228) and VFE (VFE.cpp:161-189) as gp_tpu's per-device
# programs compute them (psparse.py:49-113): sums over this process's rows
# in two rounds (the second needs A^-1 of the first's totals) around the
# replicated M x M algebra
# --------------------------------------------------------------------------

def _fitc_parts1(kernel, hyp, x, y, mask, u, Luu):
    """[Kux Gamma^-1 Kxu, Kux Gamma^-1 r, sum log Gamma] over the local rows,
    and (Kxu, Gamma^-1, r) for the second round."""
    nc = kernel.num_hyp(x.shape[1])
    chyp = hyp[:nc]
    sn2 = hyp_sn2(hyp)
    r = (y - hyp_mean(hyp)) * mask
    Kxu = kernel.k(chyp, x, u) * mask[:, None]
    V = solve_lower(Luu, Kxu.T)
    qdiag = torch.sum(V * V, dim=0)
    sf2 = kernel.diag_k(chyp, x)
    gamma = torch.where(mask > 0, 1.0 + torch.maximum(sf2 - qdiag,
                                                      zero_like(sf2)) / sn2,
                        torch.ones_like(sf2))
    ig = 1.0 / gamma
    return [(Kxu.T * ig) @ Kxu, Kxu.T @ (ig * r),
            torch.sum(torch.log(gamma))], (Kxu, ig, r)


def _fitc_mid(hyp, Kuu, T1):
    """(A^-1 t1, chol(A)), A = sn2 Kuu + B."""
    B, t1, _ = T1
    LA = library_cholesky(hyp_sn2(hyp) * Kuu + B)
    return chol_solve(LA, t1), LA


def _fitc_parts2(aux, v):
    Kxu, ig, r = aux
    return [torch.dot(ig * r, r - Kxu @ v)]


def _fitc_tail(hyp, Kuu, Luu, LA, T1, T2, n: int):
    m = Kuu.shape[0]
    sn2 = hyp_sn2(hyp)
    fit = T2[0] / sn2
    complexity = (chol_logdet(LA) - chol_logdet(Luu) + T1[2]
                  + (n - m) * torch.log(sn2))
    return 0.5 * (fit + complexity + n * math.log(2 * math.pi))


def _vfe_parts1(kernel, hyp, x, y, mask, u, Luu):
    """[Kux Kxu, Kux r, sum sf2, |Luu^-1 Kux|_F^2] over the local rows, and
    (Kxu, r) for the second round."""
    nc = kernel.num_hyp(x.shape[1])
    chyp = hyp[:nc]
    r = (y - hyp_mean(hyp)) * mask
    Kxu = kernel.k(chyp, x, u) * mask[:, None]
    V = solve_lower(Luu, Kxu.T)
    return [Kxu.T @ Kxu, Kxu.T @ r,
            torch.sum(kernel.diag_k(chyp, x) * mask),
            torch.sum(V * V)], (Kxu, r)


def _vfe_mid(hyp, Kuu, T1):
    """(A^-1 Kux r, chol(A)), A = sn2 Kuu + Kux Kxu."""
    Kuxxu, Kxr, _, _ = T1
    LA = library_cholesky(hyp_sn2(hyp) * Kuu + Kuxxu)
    return chol_solve(LA, Kxr), LA


def _vfe_parts2(aux, v):
    Kxu, r = aux
    return [torch.dot(r, r - Kxu @ v)]


def _vfe_tail(hyp, Kuu, Luu, LA, T1, T2, n: int):
    _, _, sf2_sum, vv = T1
    m = Kuu.shape[0]
    sn2 = hyp_sn2(hyp)
    data_fit = 0.5 * T2[0] / sn2
    complexity = 0.5 * (chol_logdet(LA) - chol_logdet(Luu)
                        + (n - m) * torch.log(sn2))
    resid = sf2_sum - vv
    trace_term = 0.5 * torch.maximum(resid, zero_like(resid)) / sn2
    return 0.5 * n * math.log(2 * math.pi) + complexity + data_fit \
        + trace_term


_MODELS = {"fitc": (_fitc_parts1, _fitc_mid, _fitc_parts2, _fitc_tail),
           "vfe": (_vfe_parts1, _vfe_mid, _vfe_parts2, _vfe_tail)}


def _kuu(kernel, hyp, u, jitter):
    Kuu = kernel.k(hyp[:kernel.num_hyp(u.shape[1])], u, u) \
        + jitter * eye_like(u.shape[0], u)
    return Kuu, library_cholesky(Kuu)


def _flat(ts):
    return torch.cat([t.reshape(-1) for t in ts])


def _unflat(v, like):
    out, i = [], 0
    for t in like:
        out.append(v[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def _reduced_leaves(parts, axis, want_grad: bool):
    """The parts' sums over the axis, as (detached) leaves."""
    totals = _unflat(psum(_flat(parts).detach(), axis), parts)
    return [t.clone().requires_grad_(want_grad) for t in totals]


def _zeros_for_none(grads, like):
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, like)]


def _pnll_value_grad(model, kernel, hyp, xs, ys, mask, u, jitter, n, axis,
                     want_grad: bool):
    """(NLL, dNLL/dhyp or None), both replicated.

    The forward: Kuu, Luu (replicated); round 1, this process's parts from
    leaf copies h_loc, L_loc of hyp and Luu, all_reduced into leaves T1;
    v = A^-1 (...) from T1 (replicated); round 2, the parts at a leaf copy
    of v, all_reduced into T2; the tail.  The backward, as the module
    docstring sets out: the cotangent of T2 through round 2 (to h_loc,
    L_loc and v, v's summed over processes), then T1's (directly and
    through v) through round 1, the local hyp and Luu cotangents summed,
    and the replicated graph's hyp gradient with v's and Luu's summed
    cotangents."""
    parts1_fn, mid_fn, parts2_fn, tail_fn = _MODELS[model]
    h = hyp.detach().requires_grad_(want_grad)
    with torch.set_grad_enabled(want_grad):
        Kuu, Luu = _kuu(kernel, h, u, jitter)
        h_loc = hyp.detach().requires_grad_(want_grad)
        L_loc = Luu.detach().requires_grad_(want_grad)
        parts1, aux = parts1_fn(kernel, h_loc, xs, ys, mask, u, L_loc)
        T1 = _reduced_leaves(parts1, axis, want_grad)
        v, LA = mid_fn(h, Kuu, T1)
        v_loc = v.detach().requires_grad_(want_grad)
        parts2 = parts2_fn(aux, v_loc)
        T2 = _reduced_leaves(parts2, axis, want_grad)
        nll = tail_fn(h, Kuu, Luu, LA, T1, T2, n)
    if not want_grad:
        return nll, None
    c2 = torch.autograd.grad(nll, T2, retain_graph=True)
    g2 = _zeros_for_none(torch.autograd.grad(
        parts2, (h_loc, L_loc, v_loc), c2, retain_graph=True,
        allow_unused=True), (h_loc, L_loc, v_loc))
    g_v = psum(g2[2], axis)
    c1 = _zeros_for_none(torch.autograd.grad(
        (nll, v), T1, (torch.ones_like(nll), g_v), retain_graph=True,
        allow_unused=True), T1)
    g1 = _zeros_for_none(torch.autograd.grad(
        parts1, (h_loc, L_loc), c1, allow_unused=True), (h_loc, L_loc))
    g_h, g_L = _unflat(psum(_flat([g1[0] + g2[0], g1[1] + g2[1]]), axis),
                       (h_loc, L_loc))
    g_rep, = torch.autograd.grad((nll, v, Luu), h,
                                 (torch.ones_like(nll), g_v, g_L))
    return nll.detach(), g_rep + g_h


def _like(a, x):
    """a (a number, array or tensor) in x's dtype and device."""
    return torch.as_tensor(a, dtype=x.dtype, device=x.device)


def _args(x, y, u, jitter, mesh):
    ax = mesh.axis(AXIS)
    xs, ys, mask, n = _shard_rows(x, y, ax)
    return xs, ys, mask, u.to(x), _like(jitter, x), n, ax


def pnll_sparse(model: str, kernel: KernelSpec, hyp, x, y, u, jitter, mesh):
    """Distributed FITC ('fitc') / VFE ('vfe') NLL (replicated 0-d)."""
    xs, ys, mask, u, jitter, n, ax = _args(x, y, u, jitter, mesh)
    with torch.no_grad():
        return _pnll_value_grad(model, kernel, _like(hyp, x),
                                xs, ys, mask, u, jitter, n, ax, False)[0]


def pnll_sparse_vg(model: str, kernel: KernelSpec, hyp, x, y, u, jitter,
                   mesh):
    """(NLL, dNLL/dhyp), replicated; NaN/inf propagate."""
    xs, ys, mask, u, jitter, n, ax = _args(x, y, u, jitter, mesh)
    return _pnll_value_grad(model, kernel, _like(hyp, x), xs,
                            ys, mask, u, jitter, n, ax, True)


def pfit_sparse(model: str, kernel: KernelSpec, noise_free: bool, x, y, u,
                jitter, vec0, lb, ub, mesh,
                max_evals: int = 130) -> LBFGSBResult:
    """Distributed bounded MLE fit of FITC ('fitc') or VFE ('vfe'):
    lbfgsb_impl on every process over the replicated value and gradient."""
    xs, ys, mask, u, jitter, n, ax = _args(x, y, u, jitter, mesh)

    def fun(v):
        f, g = _pnll_value_grad(model, kernel, from_opt_vec(v, noise_free),
                                xs, ys, mask, u, jitter, n, ax, True)
        if noise_free:
            g = torch.cat([g[:-2], g[-1:]])
        return sanitize_value_and_grad(f, g)

    vec0, lb, ub = (_like(a, x) for a in (vec0, lb, ub))
    return lbfgsb_impl(fun, vec0, lb, ub, max_evals=max_evals)


@torch.no_grad()
def pset_k_sparse(model: str, kernel: KernelSpec, hyp, x, y, u, jitter0,
                  mesh, max_tries: int = 64):
    """Distributed _setK of FITC (FITC.cpp:165-200) / VFE (VFE.cpp:132-160):
    the jitter-doubling loop with the (n_loc, M) panels sharded; every
    process takes the same steps (ok reads replicated factors).  Returns
    (Luu, LA, alpha, jitter, ok), replicated M-sized, which the
    single-device predictions serve as they are."""
    xs, ys, mask, u, jit0, _, ax = _args(x, y, u, jitter0, mesh)
    hyp = _like(hyp, x)
    m = u.shape[0]
    chyp = hyp[:kernel.num_hyp(x.shape[1])]
    sn2 = hyp_sn2(hyp)
    r = (ys - hyp_mean(hyp)) * mask
    eye = eye_like(m, x)
    Kuu0 = kernel.k(chyp, u, u)
    Kxu = kernel.k(chyp, xs, u) * mask[:, None]
    sf2 = kernel.diag_k(chyp, xs)
    if model == "fitc":
        def attempt(jitter, a_jitter):
            Luu = library_cholesky(Kuu0 + jitter * eye)
            V = solve_lower(Luu, Kxu.T)
            qdiag = torch.sum(V * V, dim=0)
            ig = torch.where(mask > 0, 1.0 / (1.0 + torch.maximum(
                sf2 - qdiag, zero_like(sf2)) / sn2), torch.ones_like(sf2))
            A = sn2 * Kuu0 + psum((Kxu.T * ig) @ Kxu, ax)
            return Luu, library_cholesky(A + a_jitter * eye), ig

        jitter = jit0
        Luu, LA, ig = attempt(jitter, torch.zeros_like(jitter))
        tries = 0
        while not bool(chol_ok(Luu) & chol_ok(LA)) and tries < max_tries:
            jitter = jitter * 2.0
            Luu, LA, ig = attempt(jitter, jitter)
            tries += 1
        alpha = chol_solve(LA, psum(Kxu.T @ (ig * r), ax))
        jit_out = jitter
    else:
        Kuxxu = psum(Kxu.T @ Kxu, ax)

        def attempt(added):
            Kuu = Kuu0 + added * eye
            return library_cholesky(Kuu), library_cholesky(Kuu + Kuxxu / sn2)

        added, jitter = torch.zeros_like(jit0), jit0
        Luu, LA = attempt(added)
        tries = 0
        while not bool(chol_ok(Luu) & chol_ok(LA)) and tries < max_tries:
            added = added + jitter
            Luu, LA = attempt(added)
            jitter = jitter * 2.0
            tries += 1
        alpha = chol_solve(LA, psum(Kxu.T @ r, ax)) / sn2
        jit_out = added
    return Luu, LA, alpha, jit_out, bool(chol_ok(Luu) & chol_ok(LA))
