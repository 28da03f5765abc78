#!/usr/bin/env python3
"""Where gp_tpu's and gp_tpu_torch's exact-GP fits end, in float32 and
float64, on the CPU, from the default start.

    JAX_PLATFORMS=cpu python scripts/fit_basins.py --n 1500 [--d 24]
        [--seed 42] [--which gp_tpu gp_tpu_torch] [--dtypes float32 float64]

The data is `make_data(n + 500, d, seed)`: the first n rows train, the
rest are held out.  One JSON line per fit: final NLL, evaluations, how
the optimizer stopped (read from the projected gradient at its end, not
from `converged`), log sigma_n, and the held-out RMSE beside the constant
predictor's.  The card's fit at N = 8000 is in chip_smoke.py; this script
is the reference's witness at a size the CPU can afford.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _stop_reason(x, g, lb, ub, evals: int, max_evals: int = 160,
                 tol: float = 1e-8) -> tuple[str, float]:
    pg = float(np.max(np.abs(np.clip(x - g, lb, ub) - x)))
    if pg < tol:
        return "projected gradient below tolerance", pg
    if evals >= max_evals:
        return "evaluation budget", pg
    return "no acceptable step", pg


def fit(which: str, dtype: str, Xtr, ytr, Xte, yte) -> dict:
    t0 = time.perf_counter()
    if which == "gp_tpu":
        import jax
        jax.config.update("jax_enable_x64", True)
        from gp_tpu import GP
        from gp_tpu.models.base import to_opt_vec
        gp = GP(Xtr, ytr, dtype=dtype)
        nll = float(gp.train())
        mu = np.asarray(gp.batch_predict_y(Xte), np.float64)
    else:
        import torch
        from gp_tpu_torch import GP
        from gp_tpu_torch.models.base import to_opt_vec
        gp = GP(Xtr, ytr, device="cpu", dtype=getattr(torch, dtype))
        nll = float(gp.train())
        mu = gp.batch_predict_y(Xte).numpy().astype(np.float64)
    seconds = time.perf_counter() - t0
    res = gp.last_opt_result
    lb, ub = gp._std_bounds()
    vec = lambda a: np.asarray(to_opt_vec(a, False), np.float64)
    how, pg = _stop_reason(np.asarray(res.x, np.float64),
                           np.asarray(res.g, np.float64), vec(lb), vec(ub),
                           int(res.evals))
    hyp = np.asarray(gp.get_hyp(), np.float64)
    rmse = float(np.sqrt(np.mean((mu - yte) ** 2)))
    rmse_const = float(np.sqrt(np.mean((yte - ytr.mean()) ** 2)))
    return {"package": which, "dtype": dtype, "n": len(ytr), "nll": nll,
            "evals": int(res.evals), "stopped_by": how,
            "projected_grad": pg, "log_sn": float(hyp[-2]),
            "log_sf": float(hyp[-3]), "rmse": rmse,
            "rmse_over_const": rmse / rmse_const, "seconds": seconds}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1500)
    ap.add_argument("--d", type=int, default=24)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--which", nargs="+", default=["gp_tpu_torch", "gp_tpu"],
                    choices=["gp_tpu_torch", "gp_tpu"])
    ap.add_argument("--dtypes", nargs="+", default=["float32", "float64"],
                    choices=["float32", "float64"])
    args = ap.parse_args()
    from gp_tpu_torch.utils.synth import make_data
    X, y = make_data(args.n + 500, d=args.d, seed=args.seed)
    split = (X[:args.n], y[:args.n], X[args.n:], y[args.n:])
    for which in args.which:
        for dtype in args.dtypes:
            print(json.dumps(fit(which, dtype, *split)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
