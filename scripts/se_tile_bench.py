#!/usr/bin/env python3
"""K1/K2 (csrc/se_tile.cu) timed alone on a CUDA card, for comparing two
trees in turns.

    python3 scripts/se_tile_bench.py [--root DIR]
    python3 scripts/se_tile_bench.py --phases

Builds K1 (`se_matrix_diag`) and K2 (`se_matrix`) at chip_smoke.py's main
shape in the forms se, m52, m32 and rq (alpha 0.7 and 50), float32 and
float64, with the gp_tpu_torch of `--root` (by default this checkout; an
earlier commit unpacked beside it, so that one call times both in turns),
and prints one JSON line: per build its times as chip_smoke.py's `kernel`
records give them (`ms` back to back, `device_ms` from a CUDA graph),
whether K equals its transpose and a fingerprint of its bits (equal builds
give equal strings), and the card's name and power limit.

--phases builds this checkout's se_tile.cu with -DSE_TILE_PHASES (the phase
clocks described in its header) and runs K1 and K2 (se, float32) once at
the main shape: the mean SM cycles of a tile's phases (copy-in wait, FMA
loop, map, stores of (i, j), K1's stores of (j, i)), the blocks resident on
an SM on average, and how many of them are in their FMA loop on average.

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = (("se", 1.0), ("m52", 1.0), ("m32", 1.0), ("rq", 0.7), ("rq", 50.0))
PHASES = ("copy_in_wait", "fma_loop", "norms_and_map", "stores_ij",
          "stores_ji")
# marks recorded: blocks 0 .. MARKED - 1, slots 0-5 the phase edges, 7 the SM
MARKED = 16384


def run_phases(torch, se_tile, build, X, N, D) -> dict:
    import numpy as np
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = build.BUILD_DIR / "libse_tile_phases.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DSE_TILE_PHASES",
                    "-o", str(so), str(build.CSRC / "se_tile.cu")],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.se_tile_f32.argtypes = se_tile._ARGTYPES
    lib.phase_clock_copy.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    x = torch.as_tensor(X, dtype=torch.float32, device="cuda")
    xt = se_tile._feature_major(x, 1.0 / (x.std(dim=0) * math.sqrt(D)))
    sf2 = torch.tensor(1.3, device="cuda")
    dv = torch.full((N,), 1.31, device="cuda")
    out = torch.empty(N, N, device="cuda")
    res = {}
    for sym in (1, 0):
        for _ in range(3):
            rc = lib.se_tile_f32(xt.data_ptr(), xt.data_ptr(),
                                 sf2.data_ptr(), None, dv.data_ptr(),
                                 out.data_ptr(), N, N, D, xt.shape[1],
                                 xt.shape[1], 0, sym,
                                 torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"--phases: launch failed ({rc})")
        torch.cuda.synchronize()
        buf = np.zeros(MARKED * 8, np.uint64)
        if lib.phase_clock_copy(buf.ctypes.data, buf.nbytes):
            raise RuntimeError("--phases: copy of the clocks failed")
        t = (N + 127) // 128
        tiles = t * (t + 1) // 2 if sym else t * t
        r = buf.reshape(-1, 8)[:min(tiles, MARKED)].astype(np.int64)
        d = np.diff(r[:, :6], axis=1)
        per_sm = []
        for sm in np.unique(r[:, 7]):
            rr = r[r[:, 7] == sm]
            span = rr[:, 5].max() - rr[:, 0].min()
            per_sm.append(((rr[:, 5] - rr[:, 0]).sum() / span,
                           (rr[:, 2] - rr[:, 1]).sum() / span, len(rr)))
        per_sm = np.array(per_sm)
        res["K1" if sym else "K2"] = {
            "tiles": tiles,
            "mean_cycles": {p: float(d[:, i].mean())
                            for i, p in enumerate(PHASES)},
            "tile_cycles": float((r[:, 5] - r[:, 0]).mean()),
            "blocks_resident": float(per_sm[:, 0].mean()),
            "blocks_in_fma_loop": float(per_sm[:, 1].mean()),
            "tiles_per_sm": [int(per_sm[:, 2].min()),
                             int(per_sm[:, 2].max())]}
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("se_tile_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from chip_smoke import DIM, N_TRAIN, SEED, cuda_ms, fingerprint, \
        graph_ms, se_bound_ms, smi_line
    # the phase clocks are this checkout's source; the turns time --root's
    sys.path.insert(0, ROOT if args.phases else os.path.abspath(args.root))
    from gp_tpu_torch.ops import _build, se_tile
    from gp_tpu_torch.utils.synth import make_data
    X, _ = make_data(N_TRAIN + 1000, d=DIM, seed=SEED)
    if args.phases:
        print(json.dumps({"card": smi_line(), "phases": run_phases(
            torch, se_tile, _build, X[:N_TRAIN], N_TRAIN, DIM)}),
            flush=True)
        return 0
    _build.build(("se_tile",))
    rows = []
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        x = torch.as_tensor(X[:N_TRAIN], dtype=dtype, device="cuda")
        inv_l = 1.0 / (x.std(dim=0) * math.sqrt(DIM))
        sf2 = torch.tensor(1.3, dtype=dtype, device="cuda")
        dvals = torch.full((N_TRAIN,), 1.31, dtype=dtype, device="cuda")
        for form, alpha in CASES:
            p1 = torch.tensor(alpha, dtype=dtype, device="cuda")
            for sym, fn in ((True, lambda: se_tile.se_matrix_diag(
                    inv_l, sf2, x, dvals, form, p1)),
                    (False, lambda: se_tile.se_matrix(inv_l, sf2, x, x,
                                                      form, p1))):
                K = fn()
                bound, by = se_bound_ms(N_TRAIN, N_TRAIN, DIM, dname, sym,
                                        form)
                rows.append({"kernel": "K1" if sym else "K2", "form": form,
                             "p1": alpha, "dtype": dname,
                             "ms": cuda_ms(torch, fn),
                             "device_ms": graph_ms(torch, fn),
                             "bound_ms": bound, "bound_by": by,
                             "symmetric": bool(torch.equal(K, K.T)),
                             "bits": fingerprint(torch, K)})
                del K
            torch.cuda.empty_cache()
    print(json.dumps({"root": args.root, "card": smi_line(), "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
