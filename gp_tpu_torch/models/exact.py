"""Exact Gaussian-process regression (counterpart of gp_tpu/models/exact.py;
reference: GP.{h,cpp}).

The path, as gp_tpu takes it (exact.py:157-215):

  objective   K + sn2 I in one kernel pass (K1, ops/se_tile.py), the
              Cholesky factor, the explicit inverse, alpha = K^-1 r, and
              the structured gradient contraction (KernelSpec.k_noise_vjp_q,
              SE) or the vjp of the K1 build at Q = K^-1 - alpha alpha^T
              (Matern, RQ).  chol.factor_and_inverse picks the route: on
              a CUDA device from chol._BLOCKED_MIN_N rows gp_tpu's
              accelerator branch (K padded once to the panel multiple,
              blocked_cholesky with its per-panel diagonal inverses, K3
              leaves, and the blocked lauum spd_inv_from_chol), elsewhere
              the library factor and `cholesky_inverse`;
  posterior   set_k: K(X, X) through K2, then the sqrt(10) noise-inflation
              ladder until the factorization succeeds (GP.cpp:423-444);
              chol.cholesky routes it as above;
  prediction  the cross-covariance K(X*, X) through K2, then solves.

Test-input gradients (GP.cpp:284-296): gp_tpu vmaps value_and_grad of a
single-point function.  Here the batch is written out: K(X*, X) is built
once with X* requiring grad, and autograd of mu.sum() (or s2.sum()) gives
every point's gradient, because row i depends on X*[i] alone.

Under GP_TPU_DEBUG=1 and GP_TPU_VERBOSE_OPT=1 (base.debug_decomp_enabled)
nll_raw and nll_vg_raw print gp_tpu's per-evaluation NLL breakdown; off,
they add no host sync.  The masked family at the end of the module
(BucketedGP's) computes on the live rows of a capacity buffer with
gp_tpu's dense programs at every N: of the stream regime below only the
warm start applies to it (GP._factor_free).

The stream regime (N >= _STREAM_MIN_N = 32768 rows, gp_tpu's
exact.py:363-1139) decides gp_tpu's values at that size, and the port
returns them:

  objective   nll_vg_raw where its footprint fits the card
              (_dense_vg_bytes against sparse.hbm_budget_bytes), else
              nll_vg_streamed: L, T = L^-1, and per column tile of K^-1
              = T^T T[:, I] the vjp of K2's rows k(x_I, X).  Both give
              gp_tpu's value and gradient; the choice is a route of the
              port, as chol._BLOCKED_MIN_N is (gp_tpu always tiles there);
  posterior   set_k_streamed: gp_tpu's additive conditioning-floor rescue
              before the sqrt(10) ladder, each attempt with the refined
              NLL (one iterative-refinement step on alpha, a Hutchinson
              correction of the logdet); the cache is (invKys,) and the
              scalars in _post_aux, no factor;
  prediction  variance predictions refactor at the model's hyps
              (predict_streamed, predict_s2_with_grad_streamed); mean
              predictions read the cached invKys;
  train       a default start probes the subset-MLE warm start
              (GP.subset_init_hyps), and train() returns the refined NLL
              of the posterior (GP._nll_from_posterior).

Not carried from the stream regime, each an XLA:TPU or TPU-runtime
mechanism the card does not share: the column slabs (ops/slabbed.py,
XLA:TPU's int32 single-buffer wall; K1-K3 index in int64), the
per-tile K build into one carry (_build_k_noise_tiled, a layout copy of
XLA's; K1 builds K + sn2 I in one launch), and the hosted optimizer and
search (lbfgsb_hosted, mvmo_search_hosted, multistart_lbfgsb_hosted, the
TPU runtime's watchdog: lbfgsb_impl and the search already run one
evaluation per host step).  Nor are gp_tpu's far-pad decoy branch
(exact.py:218-309), which avoids XLA:TPU's pad and slice costs (every
spec pads once instead).
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from ..config import INF
from ..ops.blocked import add_diag, eye_pad, tri_inv
from ..ops.chol import (chol_logdet, chol_ok, chol_solve, cholesky,
                        factor_and_inverse, solve_lower, solve_lower_t)
from ..ops.kernels import KernelSpec, get_k_noise
from ..ops.solvers import CHOL, SolverSpec
from ..optim.lbfgsb import lbfgsb_impl
from .base import (GPBase, _np, debug_decomp_enabled, debug_print_nll_decomp,
                   from_opt_vec, hyp_mean, hyp_sn2, sanitize_value_and_grad,
                   to_opt_vec)

# Row count from which gp_tpu switches to its stream regime
# (exact.py:38-41): the refined NLL, the additive posterior rescue and
# the factor-free posterior.  It decides values, not memory.
_STREAM_MIN_N = 32768


def _half_n_log_2pi(n: int) -> float:
    return 0.5 * n * math.log(2 * math.pi)


# --------------------------------------------------------------------------
# Pure functions
# --------------------------------------------------------------------------

def _dense_solver_bytes(n: int, dtype) -> int:
    """The dense non-Cholesky (QR) objective's estimated peak at n rows
    (gp_tpu exact.py:50-56): the K build and the factors, ~4 N^2 words."""
    return 4 * n * n * (torch.finfo(dtype).bits // 8)


def _check_dense_solver(solver: SolverSpec, x) -> None:
    """gp_tpu's stream-scale guard for a non-Cholesky solver
    (exact.py:76-95, 612-623): from _STREAM_MIN_N rows its dense build and
    factors must fit the device's budget (sparse.hbm_budget_bytes;
    GP_TPU_HBM_BYTES raises it), else NotImplementedError: only the
    Cholesky strategy has a streamed form."""
    n = x.shape[0]
    if solver.name == "chol" or n < _STREAM_MIN_N:
        return
    from .sparse import hbm_budget_bytes
    need, budget = _dense_solver_bytes(n, x.dtype), hbm_budget_bytes(x.device)
    if need > budget:
        raise NotImplementedError(
            f"solver '{solver.name}' is unsupported at N={n} >= "
            f"{_STREAM_MIN_N} (estimated dense footprint {need} B exceeds "
            f"the {budget} B budget); use the 'chol' solver, whose "
            f"objective streams at this scale, or raise GP_TPU_HBM_BYTES "
            f"on a device where the dense build fits")


def _nll_terms(kernel: KernelSpec, hyp, x, y, solver: SolverSpec):
    """(data_fit, half_logdet, norm_const) of the NLL at hyp."""
    n = x.shape[0]
    nc = kernel.num_hyp(x.shape[1])
    r = y - hyp_mean(hyp)
    K = get_k_noise(kernel)(hyp[:nc], hyp_sn2(hyp), x, n)
    f = solver.factor(K)
    alpha = solver.solve(f, r)
    return (0.5 * torch.dot(r, alpha), 0.5 * solver.logdet(f),
            _half_n_log_2pi(n))


def _print_decomp(tag: str, data_fit, half_logdet, norm_const) -> None:
    debug_print_nll_decomp(tag, nlz=data_fit + half_logdet + norm_const,
                           data_fit=data_fit, half_logdet=half_logdet,
                           norm_const=norm_const)


def nll_raw(kernel: KernelSpec, hyp, x, y, solver: SolverSpec = CHOL):
    """Negative log marginal likelihood; NaN/inf propagate.
    GP::_calcNegLogProb (GP.cpp:120-148).  Under debug_decomp_enabled()
    prints gp_tpu's "nll" breakdown (exact.py:113-118)."""
    _check_dense_solver(solver, x)
    data_fit, half_logdet, norm_const = _nll_terms(kernel, hyp, x, y,
                                                   solver)
    if debug_decomp_enabled():
        _print_decomp("nll", data_fit, half_logdet, norm_const)
    return data_fit + half_logdet + norm_const


def _inf_where_nonfinite(v):
    return torch.where(torch.isfinite(v), v, torch.full_like(v, INF))


def nll(kernel: KernelSpec, hyp, x, y, solver: SolverSpec = CHOL):
    return _inf_where_nonfinite(nll_raw(kernel, hyp, x, y, solver))


def nll_vg_raw(kernel: KernelSpec, hyp, x, y, blocked=None,
               solver: SolverSpec = CHOL):
    """NLL + analytic hyperparameter gradient via the explicit inverse
    (GP.cpp:120-176):

        Q = K^-1 - alpha alpha^T
        g_cov_i = 0.5 sum(Q o dK/dtheta_i);  g_noise = sn2 tr(Q);
        g_mean = -sum(alpha)

    The SE specs contract the gradient without forming Q
    (KernelSpec.k_noise_vjp_q); any other spec takes gp_tpu's generic
    branch (exact.py:203-209): Q is formed, in place of K^-1, and the vjp
    of the k_noise build at Q gives the (chyp, sn2) cotangents.

    blocked: the factor's route, as chol.factor_and_inverse takes it
    (None: by size and device).  NaN/inf propagate (the caller
    sanitizes).  No host sync: every scalar stays on the device, unless
    debug_decomp_enabled(), which prints gp_tpu's "nll_vg" breakdown
    (exact.py:198-202).

    solver: a non-Cholesky strategy (QR, QR_PIVOT) factors K with it, and
    K^-1 = solver.solve(f, I), symmetrized.  gp_tpu takes that gradient by
    reverse-mode AD through the factorization (exact.py:612-626), which
    for the pivoted QR keeps the loop's carries, O(N^3) memory that no
    card holds at N = 8000.  The analytic form gives the same gradient:
    d log|det K| = tr(K^-1 dK) for any invertible K, and QR's
    logAbsDeterminant and solve are those of K.  Its breakdown prints as
    gp_tpu's QR objective prints it, under "nll".

    From _STREAM_MIN_N rows on it gives gp_tpu's stream-regime values,
    those of nll_vg_streamed: alpha by chol_solve(L, r), not by K^-1 r
    (in float32 at N = 51200 the explicit inverse's matvec moves the NLL
    by 1.6e-3 relative and the gradient by 1.2e-2 of its largest entry,
    chip_smoke.py's stream_at_golden), and the "nll_vg_streamed" tag."""
    stream = x.shape[0] >= _STREAM_MIN_N
    value, grad, terms = _nll_vg_terms(kernel, hyp, x, y, blocked, stream,
                                       solver)
    if debug_decomp_enabled():
        tag = ("nll" if solver.name != "chol" else
               "nll_vg_streamed" if stream else "nll_vg")
        _print_decomp(tag, *terms)
    return value, grad


def _nll_vg_terms(kernel: KernelSpec, hyp, x, y, blocked,
                  alpha_by_factor: bool, solver: SolverSpec = CHOL):
    """(value, grad, (data_fit, half_logdet, norm_const)) of nll_vg_raw.
    alpha_by_factor: the Cholesky solver's alpha by chol_solve(L, r), else
    by the explicit inverse's matvec K^-1 r."""
    n = x.shape[0]
    nc = kernel.num_hyp(x.shape[1])
    chyp = hyp[:nc]
    sn2 = hyp_sn2(hyp)
    generic = kernel.k_noise_vjp_q is None
    # the generic branch differentiates the build at leaves of its own
    leaves = (chyp.detach().requires_grad_(generic),
              sn2.detach().requires_grad_(generic))
    with torch.set_grad_enabled(generic):
        K_build = get_k_noise(kernel)(*leaves, x, n)
    K = K_build.detach()
    r = y - hyp_mean(hyp)
    if solver.name == "chol":
        L, Kinv = factor_and_inverse(K, blocked)
        # gp_tpu's dense form takes alpha from the (already needed)
        # explicit inverse, one matvec; its stream regime and its masked
        # family solve with the factor
        alpha = chol_solve(L, r) if alpha_by_factor else Kinv @ r
        half_logdet = 0.5 * chol_logdet(L)
        del L
    else:
        f = solver.factor(K)
        alpha = solver.solve(f, r)
        half_logdet = 0.5 * solver.logdet(f)
        Kinv = solver.solve(f, torch.eye(n, dtype=x.dtype, device=x.device))
        del f
        Kinv = 0.5 * (Kinv + Kinv.T)
    terms = (0.5 * torch.dot(r, alpha), half_logdet, _half_n_log_2pi(n))
    value = terms[0] + terms[1] + terms[2]
    if generic:
        # Q = Kinv - alpha alpha^T, written over Kinv (dead from here)
        Q = Kinv.addr_(alpha, alpha, alpha=-1.0)
        g_cov_t, g_sn2 = torch.autograd.grad(K_build, leaves, Q)
        del Q, Kinv, K_build
    else:
        g_cov_t, g_sn2 = kernel.k_noise_vjp_q(chyp, sn2, x, n, K, Kinv,
                                              alpha)
    g_sn = sn2 * g_sn2        # = sn2 (tr(Kinv) - a^T a)
    g_mean = -torch.sum(alpha)
    grad = torch.cat([0.5 * g_cov_t,
                      torch.stack([g_sn, g_mean]).to(g_cov_t.dtype)])
    return value, grad, terms


# --------------------------------------------------------------------------
# Stream regime (gp_tpu exact.py:363-946)
# --------------------------------------------------------------------------

# Words of N^2 (in the data's dtype) that nll_vg_raw adds at its peak, by
# kernel family, a little above torch.cuda.max_memory_allocated over one
# evaluation on an H100 (scripts/stream_bench.py at N = 16384: SE 4.176,
# Matern-5/2 8.000, Matern-3/2 6.001, RQ 7.000, the same in float32 and
# float64; chip_smoke.py's stream_at_golden checks SE's at N = 51200).
# SE contracts its gradient (K, L, T and K^-1 live while the lauum
# inverse runs); the others take the vjp of the K1 build at Q, whose
# backward holds N^2 temporaries beside K and Q.  A family not listed
# takes the largest.
_DENSE_VG_WORDS = {"se": 4.2, "matern52": 8.1, "matern32": 6.1, "rq": 7.1}


def _dense_vg_bytes(kernel: KernelSpec, n: int, dtype) -> int:
    """nll_vg_raw's estimated peak at n rows."""
    words = _DENSE_VG_WORDS.get(kernel.name.split("_")[0],
                                max(_DENSE_VG_WORDS.values()))
    return int(words * n * n * (torch.finfo(dtype).bits // 8))


def use_streamed_vg(kernel: KernelSpec, x) -> bool:
    """Whether objective_vg takes nll_vg_streamed: in the stream regime,
    where nll_vg_raw's estimated peak exceeds the device's budget
    (sparse.hbm_budget_bytes: GP_TPU_HBM_BYTES, else 0.75 of the card's
    memory, 12 GiB on the CPU).  A route of the port, like
    chol._BLOCKED_MIN_N: gp_tpu tiles at every stream N (exact.py:599-606)
    because its 16 GB chip holds no dense form there.  Both forms give
    gp_tpu's values; the dense one is the faster (an SE evaluation at
    N = 51200 in float32 on an H100: 3.9 s at 4.1 words of N^2 against
    5.6 s at 2.1, chip_smoke.py's stream_at_golden)."""
    from .sparse import hbm_budget_bytes
    n = x.shape[0]
    return (n >= _STREAM_MIN_N and _dense_vg_bytes(kernel, n, x.dtype)
            > hbm_budget_bytes(x.device))


def _snap_tile(n: int, tile: int) -> int:
    """gp_tpu's tile snapping (exact.py:487-496): the largest power of two
    from 2048 down to 64 below `tile` that divides n, else tile."""
    if n % tile:
        for t in (2048, 1024, 512, 256, 128, 64):
            if t < tile and n % t == 0:
                return t
    return tile


def _factor_k_noise(kernel: KernelSpec, hyp, x):
    """The Cholesky factor of K + sn2 I: the K1 build, then chol.cholesky
    (the blocked route with K3 leaves on the card).  K is freed once it is
    factored, so the peak is two N^2 buffers."""
    nc = kernel.num_hyp(x.shape[1])
    return cholesky(get_k_noise(kernel)(hyp[:nc], hyp_sn2(hyp), x,
                                        x.shape[0]))


def rademacher_probes(n: int, probes: int, seed: int, dtype, device):
    """(n, probes) Rademacher signs for the logdet correction, drawn on the
    CPU from a torch.Generator seeded with `seed` and then moved, so that
    the CPU and the card draw the same probes.  gp_tpu draws
    jax.random.bernoulli(PRNGKey(seed), 0.5, (n, probes)), which torch
    cannot reproduce: _refined_terms takes such draws as `z`."""
    g = torch.Generator().manual_seed(int(seed))
    z = torch.randint(0, 2, (n, probes), generator=g, dtype=torch.int8)
    return (2 * z - 1).to(device=device, dtype=dtype)


def _k_dot_streamed(kernel: KernelSpec, chyp, x, sn2, B,
                    tile: int = 2048):
    """(K + sn2 I) @ B without forming K: K2 row tiles k(x_I, X) of `tile`
    rows (the last one ragged), each multiplied into B (gp_tpu
    exact.py:363-377)."""
    n = x.shape[0]
    out = torch.empty_like(B)
    for j in range(0, n, tile):
        rows = kernel.k(chyp, x[j:j + tile], x)
        out[j:j + tile] = rows @ B + sn2 * B[j:j + tile]
    return out


def _refined_terms(kernel: KernelSpec, hyp, x, y, L, alpha0=None,
                   tile: int = 2048, probes: int = 16, seed: int = 0,
                   z=None):
    """(alpha, logdet, nll, tr_e2) from the factor L: one iterative-
    refinement step on alpha, alpha += K^-1 (r - K alpha), and the logdet
    corrected by tr(E), E = L^-1 K L^-T - I, estimated from Rademacher
    probes as mean(w^T K w) - n with w = L^-T z (gp_tpu exact.py:380-461).
    One _k_dot_streamed sweep serves the residual and every probe; the
    quadratic forms and tr(E) accumulate in float64, and logdet and nll
    are float64.  tr_e2 (float64, not in gp_tpu) estimates tr(E^2) from
    the same probes, mean |L^-1 K w - z|^2: log det(I + E) = tr(E) -
    tr(E^2) / 2 + ..., so tr_e2 / 4 is the size of what the first-order
    correction leaves out of nll.  z: the probes (n, probes); None draws
    rademacher_probes(n, probes, seed)."""
    n = x.shape[0]
    nc = kernel.num_hyp(x.shape[1])
    sn2 = hyp_sn2(hyp)
    r = y - hyp_mean(hyp)
    if alpha0 is None:
        alpha0 = chol_solve(L, r)
    if z is None:
        z = rademacher_probes(n, probes, seed, x.dtype, x.device)
    W = solve_lower_t(L, z.to(x.dtype))
    V = _k_dot_streamed(kernel, hyp[:nc], x, sn2,
                        torch.cat([alpha0[:, None], W], dim=1), tile)
    alpha = alpha0 + chol_solve(L, r - V[:, 0])
    f64 = torch.float64
    tr_e = torch.mean(torch.sum(W.to(f64) * V[:, 1:].to(f64), dim=0)) - n
    Ez = solve_lower(L, V[:, 1:]).to(f64) - z.to(f64)
    tr_e2 = torch.mean(torch.sum(Ez * Ez, dim=0))
    data_fit = torch.dot(r.to(f64), alpha.to(f64))
    logdet = chol_logdet(L).to(f64) + tr_e
    nll = 0.5 * data_fit + 0.5 * logdet + _half_n_log_2pi(n)
    return alpha, logdet, nll, tr_e2


def nll_refined(kernel: KernelSpec, hyp, x, y, tile: int = 2048,
                probes: int = 16, seed: int = 0, z=None):
    """The refined NLL (float64) at hyp: the factor, then _refined_terms
    (gp_tpu exact.py:380-416).  A float32 factor's NLL at N ~ 5e4 is off
    by ~1e-3 relative; the refinement repairs the data fit and the
    logdet in O(N^2)."""
    L = _factor_k_noise(kernel, hyp, x)
    return _refined_terms(kernel, hyp, x, y, L, None,
                          _snap_tile(x.shape[0], tile), probes, seed, z)[2]


def nll_vg_streamed(kernel: KernelSpec, hyp, x, y, tile: int = 4096):
    """NLL and hyperparameter gradient with two N^2 buffers, L and
    T = L^-1, plus (N, tile) panels (gp_tpu exact.py:464-587).

    tr(K^-1) = ||T||_F^2.  Per column tile I, K^-1_I = T^T T[:, I]; T is
    lower-triangular, so T[:, I] is zero above I's first row and the
    product reads T[j:] only.  The cotangent Q_I = K^-1_I^T - alpha_I
    alpha^T is contracted at once against the vjp of K2's rows
    kernel.k(chyp, x_I, X), for any covariance form.  gp_tpu's tile
    snapping is kept; where no tile divides n (or n <= tile) the K^-1
    columns come from solves of identity columns instead.  Under
    debug_decomp_enabled() prints gp_tpu's "nll_vg_streamed" breakdown
    (exact.py:507-511).  NaN/inf propagate."""
    n = x.shape[0]
    if n > tile:
        tile = _snap_tile(n, tile)
    nc = kernel.num_hyp(x.shape[1])
    chyp = hyp[:nc]
    sn2 = hyp_sn2(hyp)
    L = _factor_k_noise(kernel, hyp, x)
    r = y - hyp_mean(hyp)
    alpha = chol_solve(L, r)
    terms = (0.5 * torch.dot(r, alpha), 0.5 * chol_logdet(L),
             _half_n_log_2pi(n))
    value = terms[0] + terms[1] + terms[2]
    if debug_decomp_enabled():
        _print_decomp("nll_vg_streamed", *terms)

    def grad_tile(kinv_i, j, b):
        """0.5 sum(Q_I o dK_I/dchyp) of K^-1's columns [j, j + b)."""
        q = kinv_i.T - alpha[j:j + b, None] * alpha[None, :]
        c = chyp.detach().requires_grad_(True)
        with torch.enable_grad():
            rows = kernel.k(c, x[j:j + b], x)
        g, = torch.autograd.grad(rows, c, q)
        return 0.5 * g

    g_cov = x.new_zeros(nc)
    if n % tile == 0 and n > tile:
        T = tri_inv(L)
        del L
        tr_kinv = torch.linalg.vector_norm(T).square()
        for j in range(0, n, tile):
            g_cov += grad_tile(T[j:].T @ T[j:, j:j + tile], j, tile)
    else:
        tr_kinv = x.new_zeros(())
        for j in range(0, n, tile):
            b = min(tile, n - j)
            E = x.new_zeros((n, b))
            E[j:j + b].fill_diagonal_(1.0)
            kinv_i = chol_solve(L, E)
            tr_kinv += torch.trace(kinv_i[j:j + b])
            g_cov += grad_tile(kinv_i, j, b)
    g_sn = sn2 * (tr_kinv - torch.dot(alpha, alpha))
    grad = torch.cat([g_cov, torch.stack([g_sn, -torch.sum(alpha)])
                      .to(g_cov.dtype)])
    return value, grad


# the refined NLL's parity target (gp_tpu's, benchmarks/golden/
# tpu_fit_n51200_warm.json): set_k_streamed warns where the term its
# logdet correction leaves out is larger
REFINED_TOL = 1e-4


def set_k_streamed(kernel: KernelSpec, hyp, x, y, tile: int = 2048,
                   max_tries: int = 32, probes: int = 16, seed: int = 0,
                   z=None):
    """set_k in the stream regime (gp_tpu exact.py:692-803): returns
    (hyp', {"logdet", "nll_refined"}, invKys), the refined alpha as
    invKys; no factor is kept.

    The candidates are gp_tpu's: sn2_0, then sn2_0 + 2^k N eps mean(sf2)
    for k = 0..7 (the f32 conditioning floor, added: a fitted noise one
    rounding flip below the cliff lands within ~2x of it), then the
    reference's x sqrt(10) ladder (GP.cpp:431-440), max_tries in all.
    Each attempt builds, factors, tests the factor and, when it passed,
    computes the refined terms; its factor is dropped after it.  A raised
    noise is reported on stderr; RuntimeError when every candidate
    fails.  probes, seed, z as in _refined_terms.

    The refined NLL is first order in E = L^-1 K L^-T - I, which grows as
    the noise nears the conditioning floor: on an H100 in float32 at N =
    51200 a fit ends at sn2 ~ 0.1 of N eps mean(sf2), where the factor
    still passes and the refined NLL is 0.9 % below the float64 NLL
    (PERF.md).  Where tr(E^2) / 4, the term the expansion leaves out, is
    above REFINED_TOL of |nll_refined|, a warning says so on stderr; the
    value stays gp_tpu's."""
    n = x.shape[0]
    tile = _snap_tile(n, tile)
    nc = kernel.num_hyp(x.shape[1])
    hyp = hyp.to(x.dtype)
    log_sn0 = float(hyp[-2])
    eps = torch.finfo(x.dtype).eps
    floor = n * eps * float(torch.mean(kernel.diag_k(hyp[:nc], x)))
    sn2_0 = math.exp(2.0 * log_sn0) if math.isfinite(log_sn0) else 0.0
    candidates = [sn2_0] + [sn2_0 + floor * 2.0 ** k for k in range(8)]
    sn2_mult = max(sn2_0 + floor * 2.0 ** 7, eps ** 2)
    candidates += [sn2_mult * 10.0 ** (0.5 * k)
                   for k in range(1, max_tries - 8)]
    if z is None:
        z = rademacher_probes(n, probes, seed, x.dtype, x.device)
    out = None
    for tries, sn2 in enumerate(candidates):
        h = hyp.clone()
        h[-2] = 0.5 * math.log(sn2) if sn2 > 0 else -INF
        L = _factor_k_noise(kernel, h, x)
        if bool(chol_ok(L)):
            out = (h, *_refined_terms(kernel, h, x, y, L, None, tile, z=z))
            break
        del L
    if out is None:
        raise RuntimeError(
            f"set_k_streamed: posterior factorization failed after "
            f"{len(candidates)} rescue attempts (conditioning-floor "
            f"schedule then the x-sqrt(10) ladder up to "
            f"log_sn={0.5 * math.log(candidates[-1]):.2f}); refusing to "
            f"cache a NaN posterior")
    h, alpha, logdet, nll_ref, tr_e2 = out
    if tries:
        print(f"[gp_tpu_torch] set_k_streamed: noise raised from "
              f"log_sn={log_sn0:.4f} to {float(h[-2]):.4f} ({tries} rescue "
              f"attempt(s), conditioning floor {floor:.3e}) before the "
              f"factorization succeeded", file=sys.stderr, flush=True)
    left_out = 0.25 * float(tr_e2)
    if not left_out <= REFINED_TOL * abs(float(nll_ref)):
        c = candidates[tries] / floor if floor > 0 else INF
        print(f"[gp_tpu_torch] set_k_streamed: the refined NLL "
              f"{float(nll_ref):.6f} may be off by ~{left_out:.3e} "
              f"(tr(E^2)/4, left out of its first-order logdet "
              f"correction; sn2 is {c:.3e} x the conditioning floor "
              f"{floor:.3e})", file=sys.stderr, flush=True)
    return h, {"logdet": float(logdet), "nll_refined": float(nll_ref)}, \
        alpha


def objective_vg(kernel: KernelSpec, noise_free: bool, vec, x, y,
                 solver: SolverSpec = CHOL, blocked=None):
    """(value, grad) over the optimization vector, INF-sanitized: from
    nll_vg_streamed where use_streamed_vg says so, else nll_vg_raw (a
    non-Cholesky solver's analytic gradient included); blocked as in
    nll_vg_raw."""
    hyp = from_opt_vec(vec, noise_free)
    if solver.name != "chol":
        _check_dense_solver(solver, x)
        f, g_hyp = nll_vg_raw(kernel, hyp, x, y, solver=solver)
    elif use_streamed_vg(kernel, x):
        f, g_hyp = nll_vg_streamed(kernel, hyp, x, y)
    else:
        f, g_hyp = nll_vg_raw(kernel, hyp, x, y, blocked)
    return sanitize_value_and_grad(f, to_opt_vec(g_hyp, noise_free))


def _reject_loud_noise(kernel: KernelSpec, hyp, x, v):
    """v, or INF where it is not finite or sn2 > mean(sf2)
    (GP.cpp:470-471)."""
    nc = kernel.num_hyp(x.shape[1])
    sf2_mean = torch.mean(kernel.diag_k(hyp[:nc], x))
    ok = torch.isfinite(v) & (hyp_sn2(hyp) <= sf2_mean)
    return torch.where(ok, v, torch.full_like(v, INF))


def multistart_objective(kernel: KernelSpec, noise_free: bool, vec, x, y,
                         solver: SolverSpec = CHOL):
    """NLL with the sn2 > mean(sf2) rejection (GP.cpp:470-471)."""
    hyp = from_opt_vec(vec, noise_free)
    return _reject_loud_noise(kernel, hyp, x,
                              nll_raw(kernel, hyp, x, y, solver))


def _lbfgsb(fun, x, vec0, lb, ub, max_evals: int):
    """lbfgsb_impl with the optimizer state in the DATA dtype: a float64
    vec0 over float32 data is cast down (gp_tpu exact.py:643-648)."""
    vec0, lb, ub = (torch.as_tensor(a).to(device=x.device, dtype=x.dtype)
                    for a in (vec0, lb, ub))
    return lbfgsb_impl(fun, vec0, lb, ub, max_evals=max_evals)


def fit(kernel: KernelSpec, noise_free: bool, x, y, vec0, lb, ub,
        max_evals: int = 160, solver: SolverSpec = CHOL):
    """The bounded local MLE optimization (_lbfgsb of objective_vg)."""
    return _lbfgsb(lambda v: objective_vg(kernel, noise_free, v, x, y,
                                          solver), x, vec0, lb, ub, max_evals)


def set_k(kernel: KernelSpec, hyp, x, y, solver: SolverSpec = CHOL,
          max_tries: int = 64):
    """Posterior cache (GP::_setK, GP.cpp:423-444): factor K, inflating the
    noise until the solver accepts it (log_sn += log sqrt(10), restarting at
    log eps from -inf — GP.cpp:431-440), then cache invKys.

    gp_tpu's while_loop becomes a Python loop with one host sync per try.
    Returns (hyp', factors, invKys, ok): hyp' may carry inflated noise, as
    the reference mutates _hyps; ok=False means max_tries were exhausted
    (the caller must refuse to cache that posterior)."""
    nc = kernel.num_hyp(x.shape[1])
    Kcov = kernel.k(hyp[:nc], x, x)
    d0 = Kcov.diagonal().clone()
    log_eps = math.log(torch.finfo(x.dtype).eps)
    half_log10 = 0.5 * math.log(10.0)
    ls = hyp[-2].to(x.dtype)

    def factor(ls):
        # K0 + sn2 I on a fresh diagonal each try (Kcov is reused)
        Kcov.diagonal().copy_(d0)
        return solver.factor(add_diag(Kcov, torch.exp(2.0 * ls)))

    f = factor(ls)
    tries = 0
    while not bool(solver.ok(f)) and tries < max_tries:
        ls = (torch.full_like(ls, log_eps) if bool(torch.isinf(ls))
              else ls + half_log10)
        f = factor(ls)
        tries += 1
    hyp = hyp.clone()
    hyp[-2] = ls
    invKys = solver.solve(f, y - hyp_mean(hyp))
    return hyp, f, invKys, bool(solver.ok(f))


def predict(kernel: KernelSpec, hyp, x, f, invKys, xs,
            solver: SolverSpec = CHOL):
    """Batched posterior mean + variance (GP::_predict, GP.cpp:273-283).

    y*  = mean + k* invKys
    s2* = max(sf2 - sum(k* o K^-1 k*), 0) + sn2
    """
    chyp = hyp[:kernel.num_hyp(x.shape[1])]
    kt = kernel.k(chyp, xs, x)                    # (T, N)
    mu = hyp_mean(hyp) + kt @ invKys
    kks = solver.solve(f, kt.T)                   # (N, T)
    sf2 = kernel.diag_k(chyp, xs)
    s2 = torch.clamp(sf2 - torch.sum(kt * kks.T, dim=1), min=0.0) \
        + hyp_sn2(hyp)
    return mu, s2


def predict_y(kernel: KernelSpec, hyp, x, invKys, xs):
    """Mean-only path (GP::_predict_y, GP.cpp:298-314)."""
    kt = kernel.k(hyp[:kernel.num_hyp(x.shape[1])], xs, x)
    return hyp_mean(hyp) + kt @ invKys


def predict_s2(kernel: KernelSpec, hyp, x, f, xs, solver: SolverSpec = CHOL):
    """Variance-only path (GP::_predict_s2, GP.cpp:315-334)."""
    chyp = hyp[:kernel.num_hyp(x.shape[1])]
    kt = kernel.k(chyp, xs, x)
    kks = solver.solve(f, kt.T)
    sf2 = kernel.diag_k(chyp, xs)
    return torch.clamp(sf2 - torch.sum(kt * kks.T, dim=1), min=0.0) \
        + hyp_sn2(hyp)


def predict_y_with_grad(kernel: KernelSpec, hyp, x, invKys, xs):
    """(y, dy/dx*) batched over test points — the BO acquisition path
    (GP.cpp:289-293)."""
    xs = xs.detach().requires_grad_(True)
    with torch.enable_grad():
        mu = predict_y(kernel, hyp, x, invKys, xs)
        g, = torch.autograd.grad(mu.sum(), xs)
    return mu.detach(), g


def predict_s2_with_grad(kernel: KernelSpec, hyp, x, f, xs,
                         solver: SolverSpec = CHOL):
    """(s2, ds2/dx*) batched over test points.  The value is clamped at 0
    (GP.cpp:283); the gradient ignores the clamp, exactly as the
    reference's analytic gs2 does (GP.cpp:294): a straight-through clamp,
    as gp_tpu's _predict_s2_single."""
    chyp = hyp[:kernel.num_hyp(x.shape[1])]
    xs = xs.detach().requires_grad_(True)
    with torch.enable_grad():
        kt = kernel.k(chyp, xs, x)
        kks = solver.solve(f, kt.T)
        quad = torch.sum(kt * kks.T, dim=1)
        sf2 = kernel.diag_k(chyp, xs)
        raw = sf2 - quad + hyp_sn2(hyp)
        clamped = torch.clamp(sf2 - quad, min=0.0) + hyp_sn2(hyp)
        s2 = raw + (clamped - raw).detach()
        g, = torch.autograd.grad(s2.sum(), xs)
    return s2.detach(), g


def predict_streamed(kernel: KernelSpec, hyp, x, invKys, xs):
    """(mu, s2) of a stream-regime posterior, which caches no factor:
    factor K at hyp, then predict's math (gp_tpu exact.py:890-909)."""
    return predict(kernel, hyp, x, (_factor_k_noise(kernel, hyp, x),),
                   invKys, xs)


def predict_s2_with_grad_streamed(kernel: KernelSpec, hyp, x, xs):
    """(s2, ds2/dx*) of a stream-regime posterior: factor K at hyp, then
    predict_s2_with_grad, whose autograd gives gp_tpu's hoisted form
    d(k*^T K^-1 k*)/dx* = 2 (dk*/dx*)^T K^-1 k*, the clamp straight
    through (gp_tpu exact.py:912-946)."""
    return predict_s2_with_grad(kernel, hyp, x,
                                (_factor_k_noise(kernel, hyp, x),), xs)


# --------------------------------------------------------------------------
# Model class
# --------------------------------------------------------------------------

class GP(GPBase):
    """Exact GP with the reference's public API surface (GP.h:79-122).

    `GP(X, y)` runs on CUDA in float32; `GP(X, y, device="cpu")` on the
    CPU in float64.  `solver` selects the MatrixSolver strategy ("chol",
    "qr", "qr_pivot"), as GP::MatrixDecomp (GP.h:22-26).  From
    _STREAM_MIN_N rows the Cholesky solver takes gp_tpu's stream regime
    (the module docstring).  train_distributed fits on a 1-D mesh or a
    2-D grid of processes (parallel/pgp.py, parallel/pchol2d.py).
    """

    _MAX_EVAL = 160

    def _in_stream_regime(self) -> bool:
        """gp_tpu's predicate (exact.py:1076-1078): the Cholesky solver
        from _STREAM_MIN_N rows.  It keys the subset-MLE warm start."""
        return (self.solver.name == "chol"
                and self.num_train >= _STREAM_MIN_N)

    def _factor_free(self) -> bool:
        """Whether the posterior is the stream regime's, which caches no
        factor (set_k_streamed): it routes the posterior, the variance
        predictions and train()'s returned NLL.  GP's in the stream
        regime; a BucketedGP's never (its capacity factor is absorb's
        state)."""
        return self._in_stream_regime()

    def subset_init_hyps(self, m: int = 8192, seed: int = 0) -> np.ndarray:
        """MLE hyps of a fit to m random rows, the large-N warm start
        (gp_tpu exact.py:964-1005): the rows are
        np.random.default_rng(seed).choice(n, m, replace=False), as
        gp_tpu's; the subset model has this model's kernel, solver, noise
        settings, dtype and device.  The noise is clamped from below at
        log_sf + 0.5 log(2 N eps): a subset MLE can fit the noise down to
        its lower bound, and that start is far off at full N.  log_sf is
        read at index num_cov - 1, as gp_tpu reads it (for RQ that entry
        is log alpha).  The defaults when n <= m."""
        n = self.num_train
        if n <= m:
            return self.get_default_hyps()
        idx = np.random.default_rng(seed).choice(n, m, replace=False)
        sub = GP(_np(self._x)[idx], _np(self._y)[idx], kernel=self.kernel,
                 dtype=self._dtype, solver=self.solver, device=self._device)
        sub.set_noise_lower_bound(self._noise_lb)
        if self._noise_free:
            sub.set_noise_free(True)
        sub.train()
        hyp = np.array(sub.get_hyp(), np.float64)
        if not self._noise_free:
            log_sf = float(hyp[self._num_cov - 1])
            eps = float(torch.finfo(self._dtype).eps)
            hyp[-2] = max(float(hyp[-2]),
                          log_sf + 0.5 * float(np.log(2.0 * n * eps)))
        return hyp

    def _warm_start_hyps(self):
        """In the stream regime, the subset-MLE start (m = min(8192,
        N / 2)) that train() probes against a default or INF start
        (gp_tpu exact.py:1007-1030); None elsewhere."""
        if not self._in_stream_regime():
            return None
        m = min(8192, self.num_train // 2)
        if m < 8:
            return None
        hyp = self.subset_init_hyps(m=m)
        print(f"[gp_tpu_torch] train: HBM-scale start recovery — "
              f"subset-MLE warm start (m={m}) probes against the given "
              f"start; subset log_sn={float(hyp[-2]):.4f}",
              file=sys.stderr, flush=True)
        return hyp

    def _nll_value(self, hyp):
        return nll(self.kernel, hyp, self._x, self._y, self.solver)

    def _objective_closure(self):
        kernel, noise_free = self.kernel, self._noise_free
        x, y, solver = self._x, self._ys, self.solver
        return lambda v: objective_vg(kernel, noise_free, v, x, y, solver)

    def _multistart_objective(self):
        kernel, noise_free = self.kernel, self._noise_free
        x, y, solver = self._x, self._ys, self.solver
        return lambda vecs: torch.stack([multistart_objective(
            kernel, noise_free, v, x, y, solver) for v in vecs])

    def _run_local_opt(self, vec0, lb_v, ub_v):
        return fit(self.kernel, self._noise_free, self._x, self._ys,
                   vec0, lb_v, ub_v, max_evals=self._MAX_EVAL,
                   solver=self.solver)

    def _update_posterior(self):
        self._post_dist = None      # a single-device posterior supersedes
        if self._factor_free():
            # the cache is invKys and the scalars; no factor
            hyp, self._post_aux, invKys = set_k_streamed(
                self.kernel, self._hyps, self._x, self._y)
            self._post = (invKys,)
            self._hyps = hyp
            return
        hyp, f, invKys, ok = set_k(self.kernel, self._hyps, self._x,
                                   self._y, self.solver)
        if not ok:
            # reference parity: _setK loops until the factorization
            # succeeds (GP.cpp:423-444) and never serves a failed factor
            raise RuntimeError(
                "posterior factorization failed after noise inflation "
                "(set_k exhausted max_tries); refusing to cache a NaN "
                "posterior")
        self._post = (*f, invKys)
        self._post_aux = None
        self._hyps = hyp

    def _nll_from_posterior(self):
        """In the stream regime, the refined NLL that set_k_streamed
        computed beside the posterior (gp_tpu exact.py:1111-1133); the
        raw data fit plus the cached logdet if that is not finite; None
        elsewhere."""
        if not (self._factor_free() and self._post is not None
                and self._post_aux is not None):
            return None
        v = self._post_aux.get("nll_refined")
        if v is not None and np.isfinite(v):
            return float(v)
        r = self._y - hyp_mean(self._hyps)
        v = float(0.5 * torch.dot(r, self._post[-1])
                  + 0.5 * self._post_aux["logdet"]
                  + _half_n_log_2pi(self.num_train))
        return v if np.isfinite(v) else INF

    def _factors(self):
        if self._factor_free():
            raise RuntimeError(
                "stream-regime posteriors cache no factor; the variance "
                "predictions refactor (predict_streamed)")
        return tuple(self._post[:-1])

    def _inv_kys(self):
        if self._post_dist is not None:
            return self._post_dist[3]
        return self._post[-1]

    # -- distributed training and serving (parallel/pgp.py, pchol2d.py) -----
    @staticmethod
    def _is_grid_mesh(mesh) -> bool:
        return {"rowg", "colg"} <= set(mesh.axis_names)

    def train_distributed(self, mesh, block: int | None = None,
                          init_hyps=None) -> float:
        """MLE fit with the N x N kernel matrix sharded over the mesh
        (gp_tpu exact.py:1141-1291), optimized in the standardized space
        as train() is.  On a 1-D "rows" mesh: the block-cyclic Cholesky
        and the reduced analytic gradient (parallel/pgp.py).  On a
        ("rowg", "colg") grid (parallel/pchol2d.py) every step stays on
        the grid: the fit (pfit2d), the posterior with every rescue
        attempt (pset_k2d), the predictions (ppredict2d*) and the
        returned NLL (pnll2d).  The posterior stays sharded (this
        process's factor rows or tiles, and invKys), and the predict APIs
        serve from it.

        Every process of the mesh calls it with the same X, y (and
        init_hyps), and every process returns the same final NLL (the
        distributed NLL at the posterior's hyps).  From _STREAM_MIN_N rows
        a default start is probed against the subset-MLE warm start, as
        gp_tpu probes it: two distributed evaluations, the warm hyps
        broadcast from the mesh's first process.  block=None takes
        pchol.auto_block over the mesh's processes."""
        from ..parallel import pchol, pchol2d, pgp

        grid = self._is_grid_mesh(mesh)
        if grid:
            pnll_vg, pfit, pset_k = (pchol2d.pnll_vg2d, pchol2d.pfit2d,
                                     pchol2d.pset_k2d)
            ax = mesh.whole
        else:
            pnll_vg, pfit, pset_k = pgp.pnll_vg, pgp.pfit, pgp.pset_k
            ax = mesh.axis(pgp.AXIS)
        used_defaults = init_hyps is None
        if init_hyps is None:
            init_hyps = self.get_default_hyps()
        hyps = np.array(_np(init_hyps), np.float64)
        if self._noise_free:
            hyps[-2] = -np.inf
        if block is None:
            block = pchol.auto_block(self.num_train, ax.size)

        def dist_nll(h):
            f, _ = pnll_vg(self.kernel, self._tensor(h), self._x, self._y,
                           mesh, block=block)
            return float(f)

        if used_defaults and self.num_train >= _STREAM_MIN_N:
            warm = self._tensor(self.subset_init_hyps(
                m=min(8192, self.num_train // 2)))
            warm = _np(pchol.broadcast_from(warm, 0, ax)).astype(np.float64)
            f_def, f_warm = dist_nll(hyps), dist_nll(warm)
            if np.isfinite(f_warm) and (not np.isfinite(f_def)
                                        or f_warm < f_def):
                print(f"[gp_tpu_torch] train_distributed: subset-MLE warm "
                      f"start wins the probe ({f_warm:.4g} < {f_def:.4g})",
                      file=sys.stderr, flush=True)
                hyps = warm

        nf = self._noise_free
        lb, ub = self._std_bounds()
        lb_v = to_opt_vec(torch.from_numpy(lb), nf).numpy()
        ub_v = to_opt_vec(torch.from_numpy(ub), nf).numpy()
        vec0 = np.clip(to_opt_vec(torch.from_numpy(self._hyp_to_std(hyps)),
                                  nf).numpy(), lb_v, ub_v)
        res = pfit(self.kernel, nf, self._x, self._ys, self._tensor(vec0),
                   self._tensor(lb_v), self._tensor(ub_v), mesh, block=block,
                   max_evals=self._MAX_EVAL)
        self.last_opt_result = res._replace(
            f=res.f + self.num_train * float(np.log(self._y_sigma)))
        self._hyps = self._tensor(self._hyp_from_std(
            _np(from_opt_vec(res.x, nf)).astype(np.float64)))
        hyp, L, invKys, ok = pset_k(self.kernel, self._hyps, self._x,
                                    self._y, mesh, block=block)
        if not ok:
            raise RuntimeError(
                "distributed posterior factorization failed after noise "
                "inflation (pset_k exhausted max_tries); refusing to cache "
                "a NaN posterior")
        self._hyps = hyp
        self._post = None
        self._post_aux = None
        self._post_dist = (mesh, block, L, invKys)
        self._trained = True
        if grid:
            return float(pchol2d.pnll2d(self.kernel, self._hyps, self._x,
                                        self._y, mesh, block=block))
        return dist_nll(_np(self._hyps))

    def restore_distributed(self, mesh, block=None):
        """Attach a distributed posterior read from a checkpoint
        (utils/checkpoint stores the gathered L and invKys with their
        layout): a 1-D file needs a "rows" axis of the checkpoint's
        process count, a grid file a ("rowg", "colg") grid of its
        (Pr, Pc) shape; else ValueError.  Each process keeps its own rows
        or tiles."""
        from ..parallel import pchol, pchol2d, pgp

        if self._post_dist_pending is None:
            raise ValueError("no pending distributed posterior to restore")
        layout, blk, L_np, invKys_np = self._post_dist_pending
        if isinstance(layout, tuple):
            pr, pc = layout
            if not self._is_grid_mesh(mesh):
                raise ValueError(
                    f"checkpointed posterior is blocked for a ({pr}, {pc}) "
                    f"('rowg', 'colg') grid; mesh axes are "
                    f"{mesh.axis_names}")
            g = pchol2d.grid_of(mesh)
            if (g.pr, g.pc) != (pr, pc):
                raise ValueError(
                    f"checkpointed posterior is blocked for a ({pr}, {pc}) "
                    f"grid; mesh is ({g.pr}, {g.pc})")
            L = pchol2d.local_tiles(L_np, g.r, g.c)
        else:
            if self._is_grid_mesh(mesh) or pgp.AXIS not in mesh.axis_names \
                    or mesh.shape[pgp.AXIS] != layout:
                raise ValueError(
                    f"checkpointed posterior is blocked for {layout} "
                    f"devices on axis '{pgp.AXIS}'; mesh has axes "
                    f"{mesh.axis_names} shape {dict(mesh.shape)}")
            L = torch.from_numpy(np.ascontiguousarray(
                pchol.local_rows(L_np, mesh.axis(pgp.AXIS))))
        self._post_dist = (mesh, blk if block is None else block,
                           self._tensor(L), self._tensor(invKys_np))
        self._post_dist_pending = None
        self._post = None
        self._trained = True

    def _ppredict_dist(self, xs, with_grad: bool):
        from ..parallel import pchol2d, pgp
        mesh, block, L, invKys = self._post_dist
        xs = self._as_batch(xs)
        if self._is_grid_mesh(mesh):
            fn = (pchol2d.ppredict2d_with_grad if with_grad
                  else pchol2d.ppredict2d)
            return fn(self.kernel, self._hyps, self._x, L, invKys, xs, mesh)
        fn = pgp.ppredict_with_grad if with_grad else pgp.ppredict
        return fn(self.kernel, self._hyps, self._x, L, invKys, xs, mesh,
                  block=block)

    # -- prediction API (GP.h:104-119); tensors on the model's device --------
    # In the stream regime the variance paths refactor; the mean paths
    # read the cached invKys (gp_tpu exact.py:1353-1416).  A distributed
    # posterior serves through parallel/pgp.py or, on a grid, through
    # parallel/pchol2d.py (exact.py:1334-1410).
    def batch_predict(self, xs):
        self._require_trained()
        if self._post_dist is not None:
            return self._ppredict_dist(xs, False)
        if self._factor_free():
            return predict_streamed(self.kernel, self._hyps, self._x,
                                    self._inv_kys(), self._as_batch(xs))
        return predict(self.kernel, self._hyps, self._x, self._factors(),
                       self._inv_kys(), self._as_batch(xs), self.solver)

    def batch_predict_y(self, xs):
        self._require_trained()
        return predict_y(self.kernel, self._hyps, self._x, self._inv_kys(),
                         self._as_batch(xs))

    def batch_predict_s2(self, xs):
        self._require_trained()
        if self._post_dist is not None or self._factor_free():
            return self.batch_predict(xs)[1]
        return predict_s2(self.kernel, self._hyps, self._x, self._factors(),
                          self._as_batch(xs), self.solver)

    def batch_predict_y_with_grad(self, xs):
        self._require_trained()
        if self._post_dist is not None:
            y, gy, _, _ = self._ppredict_dist(xs, True)
            return y, gy
        return predict_y_with_grad(self.kernel, self._hyps, self._x,
                                   self._inv_kys(), self._as_batch(xs))

    def batch_predict_s2_with_grad(self, xs):
        self._require_trained()
        if self._post_dist is not None:
            _, _, s2, gs2 = self._ppredict_dist(xs, True)
            return s2, gs2
        if self._factor_free():
            return predict_s2_with_grad_streamed(
                self.kernel, self._hyps, self._x, self._as_batch(xs))
        return predict_s2_with_grad(self.kernel, self._hyps, self._x,
                                    self._factors(), self._as_batch(xs),
                                    self.solver)


# --------------------------------------------------------------------------
# Masked-capacity family (gp_tpu exact.py:1420-1606), for BucketedGP
# --------------------------------------------------------------------------
#
# gp_tpu runs these over a fixed-capacity buffer whose live row count is a
# traced scalar, so that adding a point re-runs the same compiled program;
# the pad rows are identity-masked (K_pad = blockdiag(K, I), r_pad = 0),
# which gives the live rows' NLL, gradient and posterior exactly.  The
# port has no trace to keep: the functions here take gp_tpu's arguments
# and compute on x_pad[:n_real] through the terms above (K1, the blocked
# route with its K3 leaves, K2), and BucketedGP's predictions are GP's
# over views of the live rows.  Only the posterior factor keeps gp_tpu's
# capacity layout, blockdiag(L, I), so that append_posterior_masked
# writes one row in place.
#
# What sets the family apart from GP's own functions is gp_tpu's: at
# every N it runs the dense programs (no stream form, no refined NLL, no
# dense-solver budget guard), its objective takes alpha by the factor,
# chol_solve(L, r) (exact.py:1479), and it prints no NLL breakdown.

def _masked_k(kernel: KernelSpec, chyp, x_pad, n_real: int):
    """K0 over the buffer with identity pad rows and columns,
    blockdiag(K(X, X), I): the layout of the capacity factor."""
    x = x_pad[:n_real]
    return eye_pad(kernel.k(chyp, x, x), x_pad.shape[0] - n_real)


def nll_raw_masked(kernel: KernelSpec, hyp, x_pad, y_pad, n_real: int,
                   solver: SolverSpec = CHOL):
    """NLL over the first n_real rows of a buffer (gp_tpu
    exact.py:1442-1456)."""
    return sum(_nll_terms(kernel, hyp, x_pad[:n_real], y_pad[:n_real],
                          solver))


def nll_vg_raw_masked(kernel: KernelSpec, hyp, x_pad, y_pad, n_real: int,
                      blocked=None, solver: SolverSpec = CHOL):
    """NLL and analytic gradient over the first n_real rows of a buffer
    (gp_tpu exact.py:1459-1492): nll_vg_raw's terms with alpha by the
    factor; a non-Cholesky solver's as in nll_vg_raw."""
    value, grad, _ = _nll_vg_terms(kernel, hyp, x_pad[:n_real],
                                   y_pad[:n_real], blocked, True, solver)
    return value, grad


def objective_vg_masked(kernel: KernelSpec, noise_free: bool, vec, x_pad,
                        y_pad, n_real: int, solver: SolverSpec = CHOL):
    """(value, grad) of nll_vg_raw_masked over the optimization vector,
    INF-sanitized (gp_tpu exact.py:1495-1505)."""
    f, g_hyp = nll_vg_raw_masked(kernel, from_opt_vec(vec, noise_free),
                                 x_pad, y_pad, n_real, solver=solver)
    return sanitize_value_and_grad(f, to_opt_vec(g_hyp, noise_free))


def multistart_objective_masked(kernel: KernelSpec, noise_free: bool, vec,
                                x_pad, y_pad, n_real: int,
                                solver: SolverSpec = CHOL):
    """nll_raw_masked with the sn2 > mean(sf2) rejection (gp_tpu
    bucketed.py:136-151)."""
    hyp = from_opt_vec(vec, noise_free)
    return _reject_loud_noise(
        kernel, hyp, x_pad[:n_real],
        nll_raw_masked(kernel, hyp, x_pad, y_pad, n_real, solver))


def fit_masked(kernel: KernelSpec, noise_free: bool, x_pad, y_pad,
               n_real: int, vec0, lb, ub, max_evals: int = 160,
               solver: SolverSpec = CHOL):
    """_lbfgsb of objective_vg_masked (gp_tpu exact.py:1508-1516)."""
    return _lbfgsb(lambda v: objective_vg_masked(
        kernel, noise_free, v, x_pad, y_pad, n_real, solver), x_pad, vec0,
        lb, ub, max_evals)


def set_k_masked(kernel: KernelSpec, hyp, x_pad, y_pad, n_real: int,
                 solver: SolverSpec = CHOL, max_tries: int = 64):
    """set_k over the first n_real rows, returned in the buffer's layout:
    (hyp', (blockdiag(L, I),), invKys zero-padded, ok), at the buffer's
    row count (a QR solver's factors each padded so, _pad_factor).  The
    factor is copied into a buffer of its own (on the blocked route
    chol.cholesky's L is a view of the panel-padded factor)."""
    cap = x_pad.shape[0]
    hyp, f, invKys, ok = set_k(kernel, hyp, x_pad[:n_real],
                               y_pad[:n_real], solver, max_tries)
    pad = cap - n_real
    return (hyp, tuple(_pad_factor(a, pad) for a in f),
            torch.cat([invKys, invKys.new_zeros(pad)]), ok)


def _pad_factor(a, pad: int):
    """A factor in the buffer's layout: a matrix as blockdiag(a, I), a
    pivot permutation (qr_pivot's perm) extended by the pad rows'
    identity."""
    if a.ndim == 1:
        return torch.cat([a, torch.arange(a.shape[0], a.shape[0] + pad,
                                          device=a.device)])
    return eye_pad(a, pad)


def append_posterior_masked(kernel: KernelSpec, hyp, x_pad, y_pad,
                            n_old: int, L, x_new, y_new):
    """The O(cap^2) posterior append: one new point enters the factor.

    With L = blockdiag(L_real, I) at the buffer's size, appending the
    point at row n_old writes one row of L:

        l          = L_real^-1 k(X, x_new)
        L[n_old, :] = [l, sqrt(k(x, x) + sn2 - |l|^2)]

    then invKys = chol_solve(L, r) over the raw targets, in place of
    set_k_masked's O(cap^3) refactorization.  gp_tpu solves for invKys
    with two triangular solves, the same value; chol_solve is set_k's
    route, and in float32 on the card the more accurate one where the
    noise sits below the f32 conditioning floor: there the mean from two
    triangular solves on the appended factor ends further from float64's
    than a refactorization's (chip_smoke.py's bucketed_stream reports the
    three gaps), from chol_solve as near.  The solves run over the whole
    (contiguous) buffer with the vectors zero past the live rows, which
    leaves them zero there.  x_pad, y_pad
    and L are written in place (gp_tpu returns updated copies).

    Returns (x_pad, y_pad, L, invKys, ok); ok (a 0-d bool tensor) is False
    when the pivot is not positive: the caller refactorizes."""
    nc = kernel.num_hyp(x_pad.shape[1])
    chyp = hyp[:nc]
    cap = x_pad.shape[0]
    x_pad[n_old] = x_new
    y_pad[n_old] = y_new
    kvec = L.new_zeros(cap)
    kvec[:n_old] = kernel.k(chyp, x_new[None, :], x_pad[:n_old])[0]
    l = solve_lower(L, kvec)                                # pads -> 0
    knn = kernel.diag_k(chyp, x_new[None, :])[0] + hyp_sn2(hyp)
    piv2 = knn - torch.dot(l, l)
    ok = piv2 > 0
    l[n_old] = torch.sqrt(torch.clamp(piv2, min=0.0))
    # the row is written only with a positive pivot (on the device, no
    # sync): otherwise L keeps its identity row, the old factor, for the
    # caller's refactorization and for the model should that fail
    L[n_old, :n_old + 1] = torch.where(ok, l[:n_old + 1],
                                       L[n_old, :n_old + 1])
    r = L.new_zeros(cap)
    r[:n_old + 1] = y_pad[:n_old + 1] - hyp_mean(hyp)
    invKys = chol_solve(L, r)
    return x_pad, y_pad, L, invKys, ok
