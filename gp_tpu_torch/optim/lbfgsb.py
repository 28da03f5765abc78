"""Box-bounded L-BFGS on torch tensors (counterpart of gp_tpu/optim/lbfgsb.py).

Replaces the reference's NLOPT LD_SLSQP local optimizer (GP.cpp:231-259)
with a hard evaluation budget (max_eval = 160 for the exact GP).

Design, as gp_tpu's: limited-memory BFGS two-loop recursion + gradient
projection onto the box + backtracking Armijo line search along the
projected path.  gp_tpu's `lax.while_loop`s become Python loops; the
state stays on the objective's device and in the data dtype, and the
line search reads its acceptance test on the host (one sync per
objective evaluation), and each accepted step its curvature and stopping
tests (profiling.host_read counts them under "host_sync.lbfgsb.*").

Objective contract (GP.cpp:147-171): fun(x) returns (f, g); non-finite f
or g must already be sanitized by the caller to (+inf, anything) — an
infinite f fails the Armijo test and the search backtracks, which
reproduces the reference's INF-objective rejection.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.profiling import host_read


class LBFGSBState(NamedTuple):
    x: torch.Tensor         # (n,) current iterate
    f: torch.Tensor         # () current objective
    g: torch.Tensor         # (n,) current gradient
    S: torch.Tensor         # (m, n) step history (circular)
    Y: torch.Tensor         # (m, n) gradient-difference history
    rho: torch.Tensor       # (m,) 1 / (s.y)
    head: int               # next write slot
    n_hist: int             # number of valid entries
    evals: int              # objective evaluations so far
    done: bool


class LBFGSBResult(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    g: torch.Tensor
    evals: int
    converged: bool


def _two_loop(state: LBFGSBState) -> torch.Tensor:
    """d = -H g from the circular history (newest entry at head - 1)."""
    m = state.S.shape[0]
    q = state.g
    alphas = []
    for i in range(state.n_hist):
        idx = (state.head - 1 - i) % m
        a = state.rho[idx] * torch.dot(state.S[idx], q)
        q = q - a * state.Y[idx]
        alphas.append(a)
    # initial Hessian scaling from the newest pair (standard gamma)
    newest = (state.head - 1) % m
    sy = torch.dot(state.S[newest], state.Y[newest])
    yy = torch.dot(state.Y[newest], state.Y[newest])
    one = torch.ones((), dtype=q.dtype, device=q.device)
    gamma = (torch.where((sy > 0) & (yy > 0), sy / yy, one)
             if state.n_hist > 0 else one)
    r = gamma * q
    for j in range(state.n_hist - 1, -1, -1):
        idx = (state.head - 1 - j) % m
        b = state.rho[idx] * torch.dot(state.Y[idx], r)
        r = r + state.S[idx] * (alphas[j] - b)
    return -r


def projected_gradient(x, g, lb, ub) -> torch.Tensor:
    """max |P(x - g) - x|: zero exactly at a stationary point in the box."""
    return torch.max(torch.abs(torch.clamp(x - g, lb, ub) - x))


def _lbfgsb_init(fun: Callable, x0, lb, ub, history: int) -> LBFGSBState:
    """Initial optimizer state (one objective evaluation)."""
    n = x0.shape[0]
    x0 = torch.clamp(x0, lb, ub)
    f0, g0 = fun(x0)
    z = lambda *s: torch.zeros(s, dtype=x0.dtype, device=x0.device)
    return LBFGSBState(x=x0, f=f0, g=g0, S=z(history, n), Y=z(history, n),
                       rho=z(history), head=0, n_hist=0, evals=1,
                       done=not host_read(torch.isfinite(f0),
                                               "lbfgsb.init"))


def _lbfgsb_run(fun: Callable, st: LBFGSBState, lb, ub, stop_evals: int,
                tol: float = 1e-8, max_backtracks: int = 25,
                armijo_c1: float = 1e-4) -> LBFGSBState:
    """Iterate from `st` until done or evals >= stop_evals."""
    m = st.S.shape[0]
    while not st.done and st.evals < stop_evals:
        d = _two_loop(st)
        # steepest descent when d is not a descent direction
        d = torch.where(torch.dot(st.g, d) < 0, d, -st.g)

        # backtracking Armijo along the projected path
        t = torch.ones((), dtype=st.x.dtype, device=st.x.device)
        accepted = False
        n_ls = 0
        while not accepted and n_ls < max_backtracks:
            xt = torch.clamp(st.x + t * d, lb, ub)
            ft, gt = fun(xt)
            dx = xt - st.x
            # a zero projected step can never be accepted
            ok = ((ft <= st.f + armijo_c1 * torch.dot(st.g, dx))
                  & torch.any(dx != 0))
            t = t * 0.5
            n_ls += 1
            accepted = host_read(ok, "lbfgsb.armijo")
        evals = st.evals + n_ls

        if not accepted:
            # no acceptable step: NLOPT would report ROUNDOFF/XTOL
            return st._replace(evals=evals, done=True)
        s = xt - st.x
        yv = gt - st.g
        sy = torch.dot(s, yv)
        S, Y, rho, head, n_hist = st.S, st.Y, st.rho, st.head, st.n_hist
        curved = sy > 1e-10 * torch.linalg.norm(s) * torch.linalg.norm(yv)
        if host_read(curved, "lbfgsb.curvature"):
            S, Y, rho = S.clone(), Y.clone(), rho.clone()
            S[head], Y[head], rho[head] = s, yv, 1.0 / sy
            head = (head + 1) % m
            n_hist = min(n_hist + 1, m)
        st = LBFGSBState(xt, ft, gt, S, Y, rho, head, n_hist, evals,
                         host_read(projected_gradient(xt, gt, lb, ub) < tol,
                                   "lbfgsb.pgrad"))
    return st


def lbfgsb_impl(fun: Callable, x0, lb, ub, max_evals: int = 160,
                tol: float = 1e-8, history: int = 10,
                max_backtracks: int = 25,
                armijo_c1: float = 1e-4) -> LBFGSBResult:
    """Minimize fun over the box [lb, ub] starting from x0.

    fun: x -> (f, g).  max_evals is the reference's NLOPT set_maxeval
    budget.  x0, lb and ub must share fun's device and dtype."""
    init = _lbfgsb_init(fun, x0, lb, ub, history)
    final = _lbfgsb_run(fun, init, lb, ub, max_evals, tol=tol,
                        max_backtracks=max_backtracks, armijo_c1=armijo_c1)
    # converged is isfinite(f), as gp_tpu sets it (lbfgsb.py:200): a run
    # that stopped inside the budget with a finite f reports SUCCESS
    return LBFGSBResult(final.x, final.f, final.g, final.evals,
                        host_read(torch.isfinite(final.f), "lbfgsb.result"))


def explain_result(res: LBFGSBResult, max_evals: int = 160) -> str:
    """Human-readable optimizer status (the reference's explain_nlopt,
    util.cpp:87-109)."""
    f = float(res.f)
    evals = int(res.evals)
    if f != f or f in (float("inf"), float("-inf")):
        return f"FAILURE: objective non-finite after {evals} evaluations"
    if bool(res.converged) and evals < max_evals:
        return (f"SUCCESS: converged (projected-gradient tolerance) after "
                f"{evals} evaluations, f = {f:.9g}")
    if evals >= max_evals:
        return (f"MAXEVAL_REACHED: stopped at the {max_evals}-evaluation "
                f"budget, f = {f:.9g}")
    return (f"STOPPED: no acceptable step (xtol/roundoff) after "
            f"{evals} evaluations, f = {f:.9g}")
