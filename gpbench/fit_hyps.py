"""Fixed hyperparameters for a configuration, fitted by the plain
reference of its model family and not by the program: scipy's L-BFGS-B
over the reference's nll_grad in float64, in the library's standardized
units and box (the reference's hyp_bounds), from the library's start.

    python3 -m gpbench.fit_hyps --config gpbench/configs/bundled_8k.json \\
        --data-seed 42,0,0 [--noise-at-floor]

fits make_data(n, d, data_seed) of synth.py, at the configuration's n
and d, with the reference of its family (families/<family>.py) on the
CUDA device (the CPU where there is none), within the library's budget
of 160 evaluations (GP.cpp:232), and prints one JSON line: `hyp` in the
library's order and original units, `nll`, `evals`, the optimizer's
`message`, and `at_bound`, the coordinates that ended on the box.
--noise-at-floor pins the noise at the library's lower bound, 1e-3
(GP.cpp:28), as for a deterministic objective.  The BO cell's set-up
rows for --seed s are make_data(n, d, (s, 0, 0)).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch
from scipy.optimize import minimize

from . import harness
from .synth import make_data

F64 = "float64"


MAX_EVALS = 160


def fit(ref, X, y, device, noise_at_floor: bool = False) -> dict:
    """`ref`: a family's Reference."""
    x = torch.as_tensor(X, dtype=torch.float64, device=device)
    yv = torch.as_tensor(y, dtype=torch.float64, device=device)
    ys, mu, sigma = ref.standardized(yv)
    lb, ub = (ref.to_standardized(b, mu, sigma).numpy()
              for b in ref.hyp_bounds(x, yv))
    if noise_at_floor:
        ub[-2] = lb[-2]
    v0 = ref.to_standardized(ref.default_hyp(x, yv).cpu(), mu, sigma)
    evals = [0]

    def fun(v):
        evals[0] += 1
        f, g = ref.nll_grad(x, ys, torch.as_tensor(v, device=device), F64)
        return f, g.cpu().numpy()

    res = minimize(fun, np.clip(v0.numpy(), lb, ub), jac=True,
                   method="L-BFGS-B", bounds=list(zip(lb, ub)),
                   options={"maxfun": MAX_EVALS, "maxiter": MAX_EVALS,
                            "ftol": 1e-13, "gtol": 1e-9})
    v = torch.as_tensor(res.x, dtype=torch.float64)
    hyp = ref.from_standardized(v, mu, sigma)
    names = ([f"log_l{k}" for k in range(x.shape[1])]
             + ["log_sf", "log_sn", "mean"])
    return {"hyp": hyp.tolist(),
            "nll": ref.nll(x, yv, hyp.to(device), F64),
            "evals": evals[0], "message": str(res.message),
            "at_bound": [names[k] for k in range(len(names))
                         if min(res.x[k] - lb[k], ub[k] - res.x[k]) < 1e-9]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpbench.fit_hyps")
    p.add_argument("--config", type=Path, required=True)
    p.add_argument("--data-seed", required=True)
    p.add_argument("--noise-at-floor", action="store_true")
    a = p.parse_args(argv)
    config = harness.load_json(a.config)
    fam = harness.family(harness.PKG.parent, a.config.stem, config)
    n, d = config["n"], config["d"]
    seed = tuple(int(s) for s in a.data_seed.split(","))
    X, y = make_data(n, d, seed)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    out = fit(fam.Reference(config), X, y, device, a.noise_at_floor)
    out.update(noise_at_floor=a.noise_at_floor, n=n, d=d,
               data_seed=list(seed),
               device=(torch.cuda.get_device_name() if device == "cuda"
                       else "cpu"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
