#!/usr/bin/env python3
"""The stream regime's two objective forms on the card: peak memory and
seconds of one evaluation, by kernel family and dtype.

    python3 scripts/stream_bench.py [--n 16384]

Exact GP on utils/synth.make_data(n, d=10, seed=42), at the
defaults' length scales with sigma_n = 0.1, for se_ard, matern52,
matern32 and rq in float32 and float64: models/exact.nll_vg_raw (dense,
with the stream regime's values) and nll_vg_streamed (tiled), one warm
evaluation then one timed (synced seconds), and the bytes each adds at
its peak
(torch.cuda.max_memory_allocated over the call, less what was allocated
before it), also in words of N^2 of the dtype: the figures behind
models/exact._DENSE_VG_WORDS.  An evaluation that runs out of memory is
reported as such.  One JSON line per case, after the card's name and
power limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gp_tpu_torch import GP  # noqa: E402
from gp_tpu_torch.models import exact  # noqa: E402
from gp_tpu_torch.utils.synth import make_data  # noqa: E402

KERNELS = ("se_ard", "matern52", "matern32", "rq")
D = 10
FORMS = {"dense": exact.nll_vg_raw, "tiled": exact.nll_vg_streamed}


def one_eval(gp, fn, hyp) -> dict:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    f, _ = fn(gp.kernel, hyp, gp._x, gp._ys)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    n, size = gp.num_train, torch.finfo(gp.dtype).bits // 8
    return {"s": secs, "peak_gb": peak / 1e9,
            "words_n2": peak / (n * n * size), "f": float(f)}


def memory_table(n: int) -> None:
    # the table's N stands in for a stream-regime one: nll_vg_raw takes
    # the regime's alpha
    exact._STREAM_MIN_N = min(exact._STREAM_MIN_N, n)
    X, y = make_data(n, d=D, seed=42)
    for kernel in KERNELS:
        for dtype in ("float32", "float64"):
            gp = GP(X, y, kernel=kernel, dtype=dtype)
            h = gp.get_default_hyps()
            h[-2] = -2.302585092994046           # sigma_n = 0.1
            hyp = gp._tensor(gp._hyp_to_std(h))
            for form, fn in FORMS.items():
                rec = {"n": n, "d": D, "kernel": kernel, "dtype": dtype,
                       "form": form}
                try:
                    one_eval(gp, fn, hyp)
                    rec.update(one_eval(gp, fn, hyp))
                except torch.cuda.OutOfMemoryError:
                    rec["out_of_memory"] = True
                print(json.dumps(rec), flush=True)
            del gp


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_bench: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    memory_table(args.n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
