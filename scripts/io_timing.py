"""Time the CLI's text reads through each of utils/io.read_matrix's paths:
the native reader (native/fastio.cpp, built with g++ at first use) and
NumPy's np.loadtxt, which read_matrix takes when the library is missing.

The files are the CLI's three, as chip_smoke.py writes them: train_x
(8000 x 24), train_y (8000 x 1) and test_x (1000 x 24) from
utils/synth.make_data(9000, d=24, seed=42), written at 17 significant
digits.  Each path reads each file REPS times; both must give the same
array.  Prints one JSON object (seconds: the build, then each read).

    python3 scripts/io_timing.py [--reps 3]

Host work only; no device is used.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gp_tpu_torch.native import fastio  # noqa: E402
from gp_tpu_torch.utils.io import write_matrix  # noqa: E402
from gp_tpu_torch.utils.synth import make_data  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    t0 = time.perf_counter()
    native_ok = fastio._load() is not None
    build_s = time.perf_counter() - t0
    X, y = make_data(9000, d=24, seed=42)
    out = {"build_or_load_s": build_s, "native_available": native_ok,
           "files": {}}
    with tempfile.TemporaryDirectory() as d:
        files = {"train_x": X[:8000], "train_y": y[:8000, None],
                 "test_x": X[8000:]}
        for name, arr in files.items():
            path = os.path.join(d, name)
            write_matrix(path, arr, "%.17g")
            rec = {"shape": list(arr.shape),
                   "bytes": os.path.getsize(path)}
            for label, read in (
                    ("native", fastio.read_matrix),
                    ("numpy", lambda p: np.loadtxt(p, dtype=np.float64,
                                                   ndmin=2))):
                if label == "native" and not native_ok:
                    continue
                secs = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    got = read(path)
                    secs.append(time.perf_counter() - t0)
                    if not np.array_equal(got, arr):
                        print(f"{label} read of {name} differs",
                              file=sys.stderr)
                        return 1
                rec[f"{label}_s"] = secs
            out["files"][name] = rec
    for label in ("native", "numpy"):
        out[f"{label}_total_s_min"] = sum(
            min(r[f"{label}_s"]) for r in out["files"].values()
            if f"{label}_s" in r)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
