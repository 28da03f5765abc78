#!/usr/bin/env python3
"""How gp_tpu's and gp_tpu_torch's L-BFGS-B fits stop on the problems of
tests/test_torch_exact.py (`FITS`), in float64 on the CPU.

    python scripts/lbfgsb_stops.py [--kernels se_iso se_ard]

From gp_tpu's own start (the one GP.train hands its optimizer) the same
objective is minimized three ways:
  - `train_fit`: gp_tpu's `exact.fit`, the jitted program GP.train runs;
  - `jit_lbfgsb`: `jax.jit` of gp_tpu's `lbfgsb_impl` on the same
    objective, the same code compiled as a different program;
  - `port`: gp_tpu_torch's `lbfgsb_impl` on the port's objective.
One JSON line per kernel: each run's evaluations, final f, projected
gradient at its end and how it stopped (read from that gradient and the
budget, not from `converged`); and, for the port, traced evaluation by
evaluation against gp_tpu's traced run: the first evaluation whose f
differs, the first whose iterate differs by more than 1e-6, and the
tail of evaluations spent within 1e-12 (relative) of the final f.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

TOL = 1e-8


def _stop(x, g, lb, ub, evals, max_evals):
    pg = float(np.max(np.abs(np.clip(x - g, lb, ub) - x)))
    how = ("projected gradient below tolerance" if pg < TOL else
           "evaluation budget" if evals >= max_evals else
           "no acceptable step")
    return {"evals": int(evals), "pg": pg, "stopped_by": how}


def run(kernel: str) -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    import gp_tpu
    from gp_tpu.models import exact as je
    from gp_tpu.optim.lbfgsb import lbfgsb_impl as j_lbfgsb
    from gp_tpu_torch import GP as TGP
    from gp_tpu_torch.models import exact as te
    from gp_tpu_torch.optim.lbfgsb import lbfgsb_impl

    from test_torch_exact import FITS, _problem

    X, y = _problem(**FITS[kernel])
    gj = gp_tpu.GP(X, y, kernel=kernel)
    gt = TGP(X, y, kernel=kernel, device="cpu")
    start = {}
    run_local = type(gj)._run_local_opt

    def capture(self, vec0, lb, ub):
        start["x0"], start["lb"], start["ub"] = (np.asarray(a) for a in
                                                 (vec0, lb, ub))
        return run_local(self, vec0, lb, ub)
    type(gj)._run_local_opt = capture
    try:
        gj.train()
    finally:
        type(gj)._run_local_opt = run_local
    x0, lb, ub = start["x0"], start["lb"], start["ub"]
    budget = gj._MAX_EVAL
    out = {"kernel": kernel, **FITS[kernel], "max_evals": budget}

    def summary(r):
        return {**_stop(np.asarray(r.x), np.asarray(r.g), lb, ub,
                        int(r.evals), budget), "f": float(r.f)}
    jx = [jnp.asarray(a) for a in (x0, lb, ub)]
    out["train_fit"] = summary(je.fit(gj.kernel, False, gj._x, gj._ys,
                                      *jx, max_evals=budget,
                                      solver=gj.solver))
    out["train_fit_is_GP_train"] = (
        out["train_fit"]["evals"] == int(gj.last_opt_result.evals))

    trace_j = []

    def fj(v):
        f, g = je.objective_vg(gj.kernel, False, v, gj._x, gj._ys)
        jax.debug.callback(lambda a, b: trace_j.append(
            (np.asarray(a), float(b))), v, f, ordered=True)
        return f, g
    out["jit_lbfgsb"] = summary(jax.jit(lambda v: j_lbfgsb(
        fj, v, jx[1], jx[2], max_evals=budget))(jx[0]))
    jax.effects_barrier()

    trace_t = []

    def ft(v):
        f, g = te.objective_vg(gt.kernel, False, v, gt._x, gt._ys)
        trace_t.append((v.numpy().copy(), float(f)))
        return f, g
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    out["port"] = summary(lbfgsb_impl(ft, t(x0), t(lb), t(ub),
                                      max_evals=budget))

    pairs = list(zip(trace_j, trace_t))
    first = lambda cond: next((i + 1 for i, p in enumerate(pairs)
                               if cond(p)), None)
    f_end = trace_t[-1][1]
    tail = next(i for i in range(len(trace_t))
                if all(abs(f - f_end) <= 1e-12 * abs(f_end)
                       for _, f in trace_t[i:]))
    out["port_vs_jit_lbfgsb"] = {
        "first_eval_f_differs": first(lambda p: p[0][1] != p[1][1]),
        "first_eval_x_apart_1e-6": first(
            lambda p: np.max(np.abs(p[0][0] - p[1][0])) > 1e-6),
        "rel_f_gap_at_end": abs(out["port"]["f"] - out["jit_lbfgsb"]["f"])
        / abs(out["jit_lbfgsb"]["f"]),
        "port_tail_evals_within_1e-12_of_final_f": len(trace_t) - tail}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", nargs="+", default=["se_ard", "se_iso"],
                    choices=["se_ard", "se_iso"])
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    for kernel in args.kernels:
        print(json.dumps(run(kernel)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
