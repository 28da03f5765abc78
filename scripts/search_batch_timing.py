#!/usr/bin/env python3
"""The search objective over a chunk of candidates, one batch against one
candidate at a time, on the card in float32 below the blocked route.

    python3 scripts/search_batch_timing.py [--n 1024 2048 4096] [--reps 3]
        [--device cuda|cpu]

Exact SE-ARD GP on utils/synth.make_data(n, d=24, seed=42).  Per n: the
model's chunk (gp_tpu's _multistart_chunk formula), chunks of candidates
from sample_box in the standardized box, and the seconds per candidate of

  batch  one K1 launch per candidate into one (c, n, n) buffer, one
         batched cholesky_ex and one batched cholesky_solve (the form
         kept here, in `batch_objective`);
  loop   models/exact.multistart_objective per candidate,

each timed over 4 chunks after one warm chunk, best of --reps, with the
largest relative difference of their values.  Prints one JSON line per n
and the card's name and power limit.
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

from gp_tpu_torch import GP  # noqa: E402
from gp_tpu_torch.config import INF  # noqa: E402
from gp_tpu_torch.models import exact  # noqa: E402
from gp_tpu_torch.models.base import (from_opt_vec, hyp_mean,  # noqa: E402
                                      hyp_sn2)
from gp_tpu_torch.ops.chol import chol_logdet, library_cholesky  # noqa: E402
from gp_tpu_torch.ops.kernels import get_k_noise  # noqa: E402
from gp_tpu_torch.optim.multistart import (GeneratorDraws,  # noqa: E402
                                            sample_box)
from gp_tpu_torch.utils.synth import make_data  # noqa: E402


def batch_objective(kernel, vecs, x, y):
    """exact.multistart_objective over the chunk vecs as one batch."""
    n, nc = x.shape[0], kernel.num_hyp(x.shape[1])
    k_noise = get_k_noise(kernel)
    hyps = [from_opt_vec(v, False) for v in vecs]
    K = x.new_empty((len(hyps), n, n))
    for i, hyp in enumerate(hyps):
        K[i] = k_noise(hyp[:nc], hyp_sn2(hyp), x, n)
    L = library_cholesky(K)
    del K
    r = torch.stack([y - hyp_mean(hyp) for hyp in hyps])
    alpha = torch.cholesky_solve(r[..., None], L)[..., 0]
    out = []
    for i, hyp in enumerate(hyps):
        v = (0.5 * torch.dot(r[i], alpha[i]) + 0.5 * chol_logdet(L[i])
             + exact._half_n_log_2pi(n))
        sf2_mean = torch.mean(kernel.diag_k(hyp[:nc], x))
        ok = torch.isfinite(v) & (hyp_sn2(hyp) <= sf2_mean)
        out.append(torch.where(ok, v, torch.full_like(v, INF)))
    return torch.stack(out)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def timed(fn, chunks, reps):
    fn(chunks[0])
    best = float("inf")
    for _ in range(reps):
        sync(chunks[0].device)
        t0 = time.perf_counter()
        vals = torch.cat([fn(c) for c in chunks[1:]])
        sync(chunks[0].device)
        best = min(best, time.perf_counter() - t0)
    return best, vals


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[1024, 2048, 4096])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    for n in a.n:
        X, y = make_data(n, d=24, seed=42)
        gp = GP(X, y, device=a.device)
        x, ys, kern = gp._x, gp._ys, gp.kernel
        chunk = gp._multistart_chunk()
        lb, ub = (torch.tensor(b, dtype=x.dtype, device=x.device)
                  for b in gp._std_bounds())
        cands = sample_box(GeneratorDraws(0), lb, ub, 5 * chunk)
        chunks = list(cands.split(chunk))
        tb, vb = timed(lambda c: batch_objective(kern, c, x, ys), chunks,
                       a.reps)
        tl, vl = timed(lambda c: torch.stack([exact.multistart_objective(
            kern, False, v, x, ys) for v in c]), chunks, a.reps)
        fin = torch.isfinite(vl)
        rel = float(((vb - vl).abs() / vl.abs())[fin].max()) \
            if bool(fin.any()) else 0.0
        print(json.dumps({
            "n": n, "chunk": chunk, "candidates": 4 * chunk,
            "finite": int(fin.sum()),
            "same_inf": bool(torch.equal(torch.isfinite(vb), fin)),
            "batch_ms_per_candidate": tb / (4 * chunk) * 1e3,
            "loop_ms_per_candidate": tl / (4 * chunk) * 1e3,
            "loop_over_batch": tl / tb, "max_rel_diff": rel}), flush=True)


if __name__ == "__main__":
    main()
