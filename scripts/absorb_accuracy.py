#!/usr/bin/env python3
"""The float32 accuracy of BucketedGP.absorb's posterior against a
refactorization's, by the route that solves for invKys.

    python3 scripts/absorb_accuracy.py [--n 32832] [--absorbs 64]
        [--hyps h1 ... h13] [--device cuda|cpu]

SE-ARD BucketedGP (bucket 128) on the first --n rows of
utils/synth.make_data(51200, d=10, seed=42), chip_smoke.py's
bucketed_stream data, at fixed hyps (default: that phase's fit from the
defaults on an H100, where the noise sits below the float32 conditioning
floor, c = sn2 / (N eps sf2) = 0.21).  The next --absorbs rows are
absorbed in float32; float32 and float64 models are factorized afresh at
the n + absorbs rows.  For the appended and the refactorized float32
factor: the mean of the 2000 held-out rows (make_data(2000, 10, seed=7))
with invKys from chol_solve (torch.cholesky_solve: set_k's route and
absorb's), from two triangular solves (gp_tpu's append) and from float64
solves of the float32 factor, each as max |mu - mu64| / max |mu64|
against the float64 factorization; each float32 solve's milliseconds;
where the two factors differ (their leading block, the appended rows,
the pivots).  Prints the card's name and power limit and one JSON line.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gp_tpu_torch import BucketedGP  # noqa: E402
from gp_tpu_torch.models import exact  # noqa: E402
from gp_tpu_torch.models.base import hyp_mean  # noqa: E402
from gp_tpu_torch.ops.chol import (chol_solve, solve_lower,  # noqa: E402
                                   solve_lower_t)
from gp_tpu_torch.utils.synth import make_data  # noqa: E402

FIT_FROM_DEFAULTS = [
    0.5342872142791748, 0.33509182929992676, 2.519803762435913,
    2.562653064727783, 1.4514331817626953, 1.4466749429702759,
    3.330702781677246, 2.724365711212158, 3.413825511932373,
    3.432278871536255, 1.2960160970687866, -2.2474026679992676,
    -0.13564327359199524]


def ms(fn, dev, reps: int = 10) -> float:
    fn()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32832)
    ap.add_argument("--absorbs", type=int, default=64)
    ap.add_argument("--hyps", type=float, nargs=13,
                    default=FIT_FROM_DEFAULTS)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    X, y = make_data(51200, d=10, seed=42)
    Xte, _ = make_data(2000, d=10, seed=7)
    n, m = a.n, a.n + a.absorbs

    def model(rows, dtype):
        bo = BucketedGP(X[:rows], y[:rows], bucket=128, dtype=dtype,
                        device=a.device)
        bo._hyps = bo._tensor(a.hyps)
        bo._update_posterior()
        bo._trained = True
        return bo

    app = model(n, torch.float32)
    for i in range(n, m):
        app.absorb(X[i], y[i])
    ref, ref64 = model(m, torch.float32), model(m, torch.float64)
    h64 = ref64._hyps
    xs = ref64._tensor(Xte)
    mu64 = exact.predict_y(ref64.kernel, h64, ref64._x, ref64._inv_kys(), xs)
    r32 = ref._y - hyp_mean(ref._hyps)
    r64 = ref64._y - hyp_mean(h64)

    def gap(ik):
        mu = exact.predict_y(ref64.kernel, h64, ref64._x, ik.double(), xs)
        return float((mu - mu64).abs().max() / mu64.abs().max())

    solves = {"chol_solve": lambda L: chol_solve(L, r32),
              "two_triangular": lambda L: solve_lower_t(
                  L, solve_lower(L, r32))}
    out = {"n": n, "absorbs": a.absorbs, "hyps": list(a.hyps)}
    for name, bo in (("appended", app), ("refactorized", ref)):
        L = bo._factors()[0]
        rec = {f"mu_gap_{s}": gap(fn(L)) for s, fn in solves.items()}
        L64 = L.double()
        rec["mu_gap_f64_solves"] = gap(chol_solve(L64, r64))
        del L64
        rec.update({f"ms_{s}": ms(lambda: fn(L), L.device)
                    for s, fn in solves.items()})
        out[name] = rec
    La, Lr = app._factors()[0], ref._factors()[0]
    out["leading_block_max_abs_diff"] = float((La[:n, :n] - Lr[:n, :n])
                                              .abs().max())
    out["appended_rows_rel_diff"] = float((La[n:] - Lr[n:]).abs().max()
                                          / Lr[n:].abs().max())
    pa, pr = La.diagonal()[n:].double(), Lr.diagonal()[n:].double()
    out["pivots_rel_diff"] = float(((pa - pr) / pr).abs().max())
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
