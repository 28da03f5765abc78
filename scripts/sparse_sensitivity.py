#!/usr/bin/env python3
"""How far the FITC and VFE objectives move when their covariance builds
move by their last bits, in float64, at chip_smoke's shape.

    python3 scripts/sparse_sensitivity.py [--n 8000] [--m 512]
        [--device cuda|cpu] [--seeds 3]

Fits FITC and VFE (SE-ARD) on chip_smoke's data (utils/synth.make_data(
n + 1000, d=24, seed=42), the first n rows) with the last m training rows
as inducing points, as chip_smoke.py does, then multiplies every entry of
each K2 build (Kuu, Kxu) by 1 + 2e-16 z, z standard normal (about the
rounding that separates the CUDA tile kernel from its plain version), and
prints, per point, the largest over the seeds of the relative change of
the objective's value and of the change of its gradient (largest entry)
relative to the gradient's largest entry and to |f|.  Points: each model
at its own fitted hyps; VFE also at FITC's; each with the noise raised to
0.1 std(y) (chip_smoke.parity_hyps).  The readings are printed last as
one JSON line; chip_smoke.py's sparse card-against-CPU limits are set
from them.
"""

import argparse
import json
import math
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import gp_tpu_torch  # noqa: E402
from gp_tpu_torch.ops import se_tile  # noqa: E402
from gp_tpu_torch.utils.synth import make_data  # noqa: E402


def raised(h, y):
    h = np.array(h, np.float64)
    h[-2] = max(h[-2], math.log(0.1 * float(np.std(y))))
    return h


def readings(model, h, seeds: int) -> dict:
    fun = model._objective_closure()
    vec = model._tensor(model._hyp_to_std(h))
    f0, g0 = fun(vec)
    gmax = float(g0.abs().max())
    build = se_tile.se_matrix
    val, grad = [], []
    for seed in range(seeds):
        gen = torch.Generator(device=model.device).manual_seed(seed)

        def perturbed(*args, **kw):
            K = build(*args, **kw)
            return K * (1 + 2e-16 * torch.randn(
                K.shape, generator=gen, dtype=K.dtype, device=K.device))
        se_tile.se_matrix = perturbed
        try:
            f1, g1 = fun(vec)
        finally:
            se_tile.se_matrix = build
        val.append(abs(float(f1 - f0)) / abs(float(f0)))
        grad.append(float((g1 - g0).abs().max()))
    f0 = float(f0)
    return {"value": val, "grad": [g / gmax for g in grad],
            "grad_over_f": [g / abs(f0) for g in grad], "grad_max_abs": gmax,
            "f": f0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, default=3)
    a = ap.parse_args()
    X, y = make_data(a.n + 1000, d=24, seed=42)
    X, y = X[:a.n], y[:a.n]
    fitted = {}
    for name in ("FITC", "VFE"):
        m = getattr(gp_tpu_torch, name)(X, y, device=a.device)
        m.set_inducing(X[-a.m:])
        m.train()
        fitted[name] = (m, m.get_hyp())
    points = [("FITC", "FITC fitted", fitted["FITC"][1]),
              ("VFE", "VFE fitted", fitted["VFE"][1]),
              ("VFE", "FITC fitted", fitted["FITC"][1])]
    out = {}
    for name, at, h in points:
        for label, hh in ((at, h), (at + ", noise raised", raised(h, y))):
            r = readings(fitted[name][0], hh, a.seeds)
            key = f"{name} at {label}"
            print(f"{key:<36} value {max(r['value']):.2e}, gradient "
                  f"{max(r['grad']):.2e} of max |g| {r['grad_max_abs']:.3e}"
                  f", {max(r['grad_over_f']):.2e} of |f| {r['f']:.10g}",
                  flush=True)
            out[key] = {k: max(r[k]) for k in ("value", "grad",
                                               "grad_over_f")}
            out[key].update(grad_max_abs=r["grad_max_abs"], f=r["f"])
    print(json.dumps({"n": a.n, "m": a.m, "device": a.device,
                      "seeds": a.seeds, "max": out}))


if __name__ == "__main__":
    main()
