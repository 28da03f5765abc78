#!/usr/bin/env python3
"""Drive gp_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and nvcc;
builds the kernels from csrc/ itself.  Exits non-zero, without the final
result line, when there is no CUDA device, when the package is missing
beside this script, or when any check fails.  Each phase prints one JSON
line:

  device     the card's name and `nvidia-smi` power limit (also printed
             raw, as nvidia-smi gives it)
  build      seconds to build the kernels, ptxas register/spill report;
             no form of the covariance tile (K1/K2), of the register
             kernel (K3's, K4's and K5's leaf), of K5's panel update or of
             the panel solve may spill
  chol_kernels  K3 (chol_inv), K4 (cholesky_block) and K5 (cholesky_panel)
             against their plain versions, float32 and float64, at
             b = 32, 128, 200 and (K4, K5) 1024, K4 also at 129, 256 and
             1000 (its blocked form above 128), K5 at w = 32 and 128 (and
             256 at b = 1024): error relative to max |L| and max |T|, the
             C entry each launched, NaN on an indefinite block (failing
             pivot 0, 20, 127; K4's and K5's masks equal to their plain
             versions', also at b = 1024 with failing pivots 0, 200, 1023,
             K5 at w = 32 and 128), CUDA-event times, bound, the library's
             time
  blocked    the blocked factor and inverse at N = 8000 (padded to 8192,
             block 1024, base 128) with the K3 leaf, with K4 and with K5
             (w = 32) as base_fn, against cholesky_ex + cholesky_inverse:
             errors, times and launch counts, float32 and float64
  kernel     each kernel in each covariance form (se, m52, m32, rq at
             alpha 0.7 and 50) against its plain PyTorch version, float32
             and float64, at the main path's shape (N = 8000, d = 24) and
             at ragged shapes: max abs error, the largest error over its
             entry's rounding bound, K1 exactly symmetric with dvals on its
             diagonal, a fingerprint of the build's bits, CUDA-event times
             of wrapper calls back to back (`ms`) and replayed from a CUDA
             graph (`device_ms`, no launch gaps), the host's enqueue of
             one, bound, and `store_ms`, a plain fill of the same output
             (the card's store rate)
  kernel_big_index  K2 at 65600 x 32768 and K1 at 46400 (float32), past
             2^31 entries: the first and last 64 rows against the plain
             version, K1's rows against its columns
  main_path  GP(X, y).train() on CUDA float32 at N = 8000, d = 24, then
             batch_predict and both *_with_grad: NLL, evaluations, fit
             seconds, evaluations per second, held-out RMSE, launches
  breakdown  CUDA-event times of the stages of one NLL+gradient evaluation:
             the blocked route's factor and inverse, and the library's
             cholesky_ex and cholesky_inverse beside them; the K1 build
             also from a CUDA graph (k1_build_device) and the host's
             enqueue of it (k1_build_host)
  route_sweep  one SE-ARD objective evaluation on each route at N from
             1024 to 8000, float32 and float64: host enqueue, synced wall
             and back-to-back times, the default route and the faster one
  f64_fit    the same fit in float64 on the card; the f32 NLL against
             the f64 NLL at the f32 fit's hyps; how each fit stopped, the
             f64 gradient at the f32 end point, and where the two fits'
             trajectories part; the f64 fit again from the same start on
             the library route, and where it parts from the blocked one
  fd_check   central finite differences (f64) against the input gradients
  main_path_matern52, breakdown_matern52, fd_check_matern52
             the same three for GP(X, y, kernel="matern52"), whose
             gradient is the vjp of the K1 build at Q = K^-1 - a a^T
  main_path_matern32, main_path_rq
             the fit and predictions with the other two kernel families
  cpu_parity the card against the CPU in f64 on a 600-point posterior,
             for se_ard and the six Matern/RQ specs
  blocked_vs_library  the f64 objective (value and gradient) through the
             blocked route against the library route at N = 8000, SE-ARD
             and Matern-5/2
  global_search  select_init_hyp (the MVMO search, num_hyp * 50
             candidates from the defaults) on the SE-ARD f32 problem:
             candidates, seconds, candidates per second, best f and f at
             the defaults, K1 launches (one per candidate) and K3 launches
             (64 per candidate), exactly; the fit from the best point
             (RMSE below 0.6 of the constant predictor's); then GP.train
             from an INF start (length scales at -200), which must enter
             the search, end finite, end no higher than the search's best
             point, and predict no worse than the constant predictor (its
             own K1/K3 counts beside the search's)
  multistart train_multistart(n_starts=4): seconds, evaluations, each
             start's f; the best NLL at most the main path's + 1e-3 |NLL|
  sparse_fitc, sparse_vfe  FITC and VFE (float64 by default) with the last
             512 training rows as inducing points: fit NLL, evaluations,
             status, seconds, evaluations per second, one evaluation's
             clock, set_k's jitter, RMSE, prediction seconds, K2 launches
             per evaluation (Kuu, Kxu) and no K1 or K3, the envelope's
             budget, K2 f64 at (8000, 512) and (512, 512) x 24 against its
             plain version with times and bound; the CPU port's value and
             NLL at the fitted hyps, and value, gradient and NLL with the
             noise raised (parity_hyps), within 1e-8, and the gradient at
             the fitted hyps within FITTED_GRAD_LIMIT; then fd_check_fitc /
             fd_check_vfe, the input gradients against central differences
             (VFE's at FITC's fitted hyps)

Each main path runs with the launch counts set to 0 just before it and
read just after; it must have gone through its own form of K1 and K2 and
no other, and through K3 at least 64 times per factorization (N = 8000
factors as 8 panels of 8 leaves), every K3 launch by its register
kernel (chol_block.launches["chol_inv_reg"]), and never through K4 or
K5.  Then comes the `kernels` line (every ported kernel and form, what
it replaces, its launches on its main path, times and bound) and, last,
the result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3
# 3.35 TB/s; float32 67 TFLOP/s outside the tensor cores (their TF32 is
# not the same work: it rounds the operands); float64 67 TFLOP/s on the
# tensor cores (DMMA), whose products are exact IEEE float64 FMAs, so the
# same work, twice the 34 TFLOP/s of the plain FMAs the port's kernels use.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}

N_TRAIN, N_TEST, DIM, SEED = 8000, 1000, 24, 42
N_GRAD = 256

# the covariance form each kernel family's builds go through
FORM_OF = {"se_ard": "se", "matern52": "m52", "matern32": "m32",
           "rq": "rq"}
# (form, p1) checked in the kernel phase; RQ at a small and a large alpha
KERNEL_CASES = [("se", 1.0), ("m52", 1.0), ("m32", 1.0), ("rq", 0.7),
                ("rq", 50.0)]
# operations per output entry beside the cross term, each sqrt, log1p and
# exp counted as one: expansion and clamp (3), then the map
MAP_OPS = {"se": 2, "m52": 10, "m32": 7, "rq": 6}
NEW_SPECS = ("matern52", "matern52_iso", "matern32", "matern32_iso", "rq",
             "rq_iso")


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def cuda_ms(torch, fn, iters: int = 20, warm: int = 3) -> float:
    """Mean milliseconds of fn() by CUDA events over `iters` runs."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 10) -> float:
    """Mean device milliseconds of fn() replayed from a CUDA graph of
    `iters` calls: what the calls do on the card, without the host's
    enqueue (its Python and launch overhead) or the gaps between
    launches that cuda_ms includes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    ms = cuda_ms(torch, graph.replay, iters=5, warm=1) / iters
    del graph
    return ms


def fingerprint(torch, K) -> str:
    """A hash of K's bits: equal builds give equal strings."""
    bits = K.contiguous().view(torch.int32 if K.dtype == torch.float32
                               else torch.int64).to(torch.int64)
    weights = torch.arange(1, bits.numel() + 1, device=K.device,
                           dtype=torch.int64) % 65521
    return f"{int((bits.flatten() * weights).sum()) & (2**64 - 1):016x}"


def host_ms(torch, fn, reps: int = 20) -> float:
    """Mean host milliseconds to enqueue fn() (no synchronize between
    calls)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def eval_clock(torch, fn, reps: int = 10) -> dict:
    """Median host milliseconds to enqueue fn() and median wall
    milliseconds to its end (a synchronize after each call, as a fit
    does), then the CUDA-event milliseconds of calls back to back."""
    import numpy as np
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    host, wall = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    return {"host_enqueue_ms": float(np.median(host)),
            "synced_wall_ms": float(np.median(wall)),
            "back_to_back_ms": cuda_ms(torch, fn, iters=reps, warm=0)}


def kernel_name(form: str, symmetric: bool) -> str:
    base = "se_tile_diag" if symmetric else "se_tile"
    return base if form == "se" else f"{base}_{form}"


def se_bound_ms(m: int, n: int, d: int, dtype: str, symmetric: bool,
                form: str = "se"):
    """Least time of one build: each input read once, the output written
    once; 2 m n d flops of cross term, 2 (m + n) d of norms, and per
    output 3 for the expansion and clamp plus MAP_OPS[form] for the map
    (SE: scale, exp)."""
    size = 4 if dtype == "float32" else 8
    rows_in = m if symmetric else m + n
    nbytes = size * (rows_in * d + m * n + 1 + (form == "rq")
                     + (m if symmetric else 0))
    flops = 2 * m * n * d + 2 * rows_in * d + (3 + MAP_OPS[form]) * m * n
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def chol_bound_ms(b: int, dtype: str, inverse: bool):
    """Least time of one b x b block Cholesky (K4, K5): b^3 / 3 flops, as
    much again for the inverse (K3); L (and L^-1) written once, and the
    block's lower triangle, all that each kernel reads of it, read once.
    Plain FMAs: TF32 tensor cores are off in the port."""
    size = 4 if dtype == "float32" else 8
    flops = (2 if inverse else 1) * b ** 3 / 3
    nbytes = size * (b * (b + 1) // 2 + (2 if inverse else 1) * b * b)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def smi_line() -> str:
    """The first card's name and power limit, as nvidia-smi gives them
    ("" when it gives none)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    out = smi.stdout.strip() if smi.returncode == 0 else ""
    return out.splitlines()[0] if out else ""


def phase_device(torch) -> dict:
    line = smi_line()
    check(line != "", "nvidia-smi gave no card")
    print(line, flush=True)
    info = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": line,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "capability": list(torch.cuda.get_device_capability(0))}
    emit("device", **info)
    return info


# kernels that may not spill, and their number of compiled forms
NO_SPILL = {"chol_inv_reg": 6, "chol_panel_update": 2,
            "chol_panel_solve": 4, "se_tile": 32}


def phase_build() -> None:
    from gp_tpu_torch.ops import _build
    seconds, log = _build.build(ptxas_info=True)
    # one entry per kernel: its mangled name, then ptxas's spill and
    # register lines for it
    report, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
        elif name and ("registers" in ln or "spill" in ln):
            report.append(f"{name}: {ln.strip()}")
    emit("build", seconds=seconds, sources=list(_build.SOURCES),
         ptxas=report)
    # these hold their tiles in registers: a spill would put them in local
    # memory.  The register kernel: K3's chol_inv_reg<T> and the leaf of K4
    # and K5, chol_inv_reg_alias<T, STORE_T> (T stored or not); K5's panel
    # update; the panel solve at its two widths (K4's 64, and 128); each
    # in f32 and f64.  K1/K2's se_tile<T, FORM, SYM, VEC>: 2 types x 4
    # forms x K1 or K2 x vector or scalar stores
    for kernel, forms in NO_SPILL.items():
        lines = [ln for ln in report if kernel in ln and "spill" in ln]
        spilled = [ln for ln in lines if any(int(n) for n in re.findall(
            r"(\d+) bytes spill", ln))]
        check(len(lines) == forms and not spilled,
              f"{kernel}: {forms} forms expected, spill report {lines}")


def phase_kernels(torch, X) -> dict:
    """Each kernel in each form against its plain version; times at the
    main shape.

    Every entry is held to its own rounding bound (se_tile.rounding_bound),
    for SE a relative error of about eps (2 d + 4) (|a|^2 + |b|^2): 1.3e-5
    at the main shape in float32.  The inverse lengthscales 1 / (std
    sqrt(d)) put |a - b|^2 near 2, so the entries are O(sf2) and a wrong
    entry shows."""
    from gp_tpu_torch.ops import se_tile
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    timed = {}
    cases = [("main", N_TRAIN, N_TRAIN, DIM), ("ragged", 1000, 777, 3),
             ("ragged", 333, 4097, 130)]
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        # the card's achievable store rate at the main shape: the bytes
        # of K1/K2's output written by a plain fill
        store_ms = cuda_ms(torch, lambda: torch.empty(
            N_TRAIN, N_TRAIN, dtype=dtype, device=dev).fill_(1.0))
        for label, m, n, d in cases:
            if label == "main":
                x1 = torch.as_tensor(X, dtype=dtype, device=dev)
                inv_l = 1.0 / (x1.std(dim=0) * math.sqrt(d))
                x2 = x1
            else:
                x1 = torch.randn(m, d, generator=gen, dtype=dtype).to(dev)
                x2 = torch.randn(n, d, generator=gen, dtype=dtype).to(dev)
                inv_l = ((torch.rand(d, generator=gen, dtype=dtype) + 0.5)
                         / math.sqrt(d)).to(dev)
            sf2 = torch.tensor(1.3, dtype=dtype, device=dev)
            xs = x1[:min(m, n)]
            dvals = torch.full((xs.shape[0],), 1.3 + 0.01, dtype=dtype,
                               device=dev)
            for form, alpha in KERNEL_CASES:
                p1 = torch.tensor(alpha, dtype=dtype, device=dev)
                k2 = lambda: se_tile.se_matrix(inv_l, sf2, x1, x2, form, p1)
                q2 = lambda: se_tile.se_matrix_plain(inv_l, sf2, x1, x2,
                                                     form, p1)
                k1 = lambda: se_tile.se_matrix_diag(inv_l, sf2, xs, dvals,
                                                    form, p1)
                q1 = lambda: se_tile.se_matrix_diag_plain(inv_l, sf2, xs,
                                                          dvals, form, p1)
                for sym, kern, plain, rows, xa, xb in (
                        (True, k1, q1, (xs.shape[0],) * 2, xs, xs),
                        (False, k2, q2, (m, n), x1, x2)):
                    name = kernel_name(form, sym)
                    out = kern()
                    torch.cuda.synchronize()
                    ref = plain()
                    check(tuple(out.shape) == rows, f"{name} shape")
                    bound = se_tile.rounding_bound(inv_l, sf2, xa, xb, ref,
                                                   form, p1)
                    err = (out - ref).abs()
                    ratio = float((err / bound).max())
                    check(math.isfinite(ratio) and ratio <= 1.0,
                          f"{name} {dname} {m}x{n}x{d} p1={alpha}: an "
                          f"entry is off by {ratio} times its rounding "
                          f"bound")
                    if sym:
                        check(bool(torch.equal(out.diagonal(), dvals)),
                              f"{name} {dname}: diagonal is not dvals")
                        check(bool(torch.equal(out, out.T)),
                              f"{name} {dname} {m}x{n}x{d} p1={alpha}: not "
                              f"exactly symmetric")
                    rec = {"kernel": name, "form": form, "p1": alpha,
                           "dtype": dname, "m": rows[0], "n": rows[1],
                           "d": d, "max_abs_err": float(err.max()),
                           "max_err_over_bound": ratio,
                           "median_bound_over_k": float(
                               (bound / ref.abs()).median()),
                           "median_k_over_sf2": float(ref.median()) / 1.3}
                    del bound, err
                    if label == "main":
                        bound_ms, by = se_bound_ms(rows[0], rows[1], d,
                                                   dname, sym, form)
                        # `ms` back to back, as every earlier PR timed
                        # it; `device_ms` leaves out the launch gaps and
                        # the wrapper's first enqueue
                        rec.update(bits=fingerprint(torch, out),
                                   ms=cuda_ms(torch, kern),
                                   device_ms=graph_ms(torch, kern),
                                   host_enqueue_ms=host_ms(torch, kern),
                                   plain_ms=cuda_ms(torch, plain, iters=5),
                                   bound_ms=bound_ms, bound_by=by,
                                   store_ms=store_ms)
                        timed[(name, dname, alpha)] = rec
                    emit("kernel", **rec)
                    del out, ref
                torch.cuda.empty_cache()
    return timed


# K2 at 65600 x 32768 and K1 at 46400 x 46400: both pass 2^31 entries
BIG_INDEX = (("se_tile", 65600, 32768), ("se_tile_diag", 46400, 46400))


def phase_big_index(torch) -> None:
    """K2 and K1 (se, float32, d = 24) past 2^31 entries, where a 32-bit
    offset would wrap: the first and last 64 rows against the plain
    version of those rows (K1's with dvals on the diagonal), each entry
    within its rounding bound; K1's rows equal to its columns there."""
    from gp_tpu_torch.ops import se_tile
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    sf2 = torch.tensor(1.3, dtype=torch.float32, device=dev)
    inv_l = ((torch.rand(DIM, generator=gen) + 0.5) / math.sqrt(DIM)).to(dev)
    for name, m, n in BIG_INDEX:
        sym = m == n
        x1 = torch.randn(m, DIM, generator=gen).to(dev)
        x2 = x1 if sym else torch.randn(n, DIM, generator=gen).to(dev)
        dvals = torch.full((m,), 1.31, device=dev)
        check(m * n > 2**31, f"{name} {m}x{n} does not pass 2^31 entries")
        out = se_tile.se_matrix_diag(inv_l, sf2, x1, dvals) if sym \
            else se_tile.se_matrix(inv_l, sf2, x1, x2)
        torch.cuda.synchronize()
        ratios = []
        for rows in (torch.arange(64, device=dev),
                     torch.arange(m - 64, m, device=dev)):
            ref = se_tile.se_matrix_plain(inv_l, sf2, x1[rows], x2)
            if sym:
                ref[torch.arange(64, device=dev), rows] = dvals[rows]
                check(bool(torch.equal(out[rows], out[:, rows].T)),
                      f"{name} {m}x{n}: rows {int(rows[0])}.. are not its "
                      f"columns")
            bound = se_tile.rounding_bound(inv_l, sf2, x1[rows], x2, ref)
            ratios.append(float(((out[rows] - ref).abs() / bound).max()))
        check(all(math.isfinite(r) and r <= 1.0 for r in ratios),
              f"{name} {m}x{n}: first/last 64 rows off by {ratios} times "
              f"their rounding bound")
        emit("kernel_big_index", kernel=name, m=m, n=n, d=DIM,
             dtype="float32", entries=m * n, max_err_over_bound=ratios)
        del out, x1, x2
        torch.cuda.empty_cache()


# K3-K5 against their plain versions: the error relative to max |L| (and
# max |T|).  K = A A^T + b I has its eigenvalues in [b, ~5b]; there the f32
# plain versions are 3e-7 of max |L| from the f64 factor at b = 128 (on the
# CPU), so two f32 computations agree well inside 1e-5; f64 is held to
# 1e-12, some 1000 ulps
CHOL_TOL = {"float32": 1e-5, "float64": 1e-12}
CHOL_SIZES = (32, 128, 129, 200, 256, 1000, 1024)
# K4 alone at these: its blocked form's first panel plus one row, two full
# panels, and a ragged last panel near the top of gp_tpu's range
K4_ONLY_SIZES = (129, 256, 1000)
K4_BIG = 1024     # the K4/K5 rows of the `kernels` line also report this b
# K5's panel widths; 256 (above the leaf's 128) divides only b = 1024 here
K5_WIDTHS = (32, 128, 256)
# failing pivots: in the first panel, inside a later one, in the last
NAN_PIVOTS = {128: (0, 20, 127), 1024: (0, 200, 1023)}
LEAF = 128            # the leaf's size on the main path (base_block)
LEAVES_PER_FACTOR = 64     # N = 8000 pads to 8192: 8 panels x 8 leaves


def _block_spd(torch, b: int, dtype, seed: int):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(b, b, generator=g, dtype=torch.float64)
    return (A @ A.T + b * torch.eye(b, dtype=torch.float64)).to("cuda",
                                                                 dtype)


def phase_chol_kernels(torch) -> dict:
    """K3, K4 and K5 against their plain versions on K = A A^T + b I, in
    f32 and f64; a non-positive pivot must give NaN from its column on.
    Library times: cholesky_ex for K4/K5, cholesky_ex then
    solve_triangular(L, I) (two calls) for K3."""
    from gp_tpu_torch.ops import chol_block as cb
    from gp_tpu_torch.ops.chol import chol_ok
    timed = {}
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        tol = CHOL_TOL[dname]
        for b in CHOL_SIZES:
            K = _block_spd(torch, b, dtype, seed=b)
            eye = torch.eye(b, dtype=dtype, device="cuda")

            def lib_pair():
                L, _ = torch.linalg.cholesky_ex(K)
                return torch.linalg.solve_triangular(L, eye, upper=False)
            cases = [("cholesky_block", None, lambda: (cb.cholesky_block(K),),
                      lambda: (cb.cholesky_block_plain(K),),
                      lambda: torch.linalg.cholesky_ex(K))]
            if b <= 200 and b not in K4_ONLY_SIZES:
                cases.insert(0, ("chol_inv", None, lambda: cb.chol_inv(K),
                                 lambda: cb.chol_inv_plain(K), lib_pair))
            for w in K5_WIDTHS:
                if b % w == 0 and b not in K4_ONLY_SIZES:
                    cases.append((
                        "cholesky_panel", w,
                        lambda w=w: (cb.cholesky_panel(K, w),),
                        lambda w=w: (cb.cholesky_panel_plain(K, w),),
                        lambda: torch.linalg.cholesky_ex(K)))
            for name, w, kern, plain, lib in cases:
                cb.reset_launches()
                out = kern()
                torch.cuda.synchronize()
                # the C entry the wrapper launched: K3's by block size
                design = {"chol_inv": cb.k3_entry(b), "cholesky_block": "chol",
                          "cholesky_panel": "chol_panel"}[name]
                check(cb.launches[design] == 1
                      and sum(cb.launches.values()) == 1,
                      f"{name} {dname} b={b}: launches {cb.launches}, "
                      f"expected one of {design}")
                ref = plain()
                errs = [rel(o, r) for o, r in zip(out, ref)]
                label = f"{name} {dname} b={b}" + (f" w={w}" if w else "")
                check(all(math.isfinite(e) and e <= tol for e in errs),
                      f"{label}: relative error {errs} > {tol}")
                check(not any(bool(torch.triu(o, 1).any()) for o in out),
                      f"{label}: nonzero above the diagonal")
                iters = 5 if b >= 1024 else 20
                bound_ms, by = chol_bound_ms(b, dname, name == "chol_inv")
                rec = {"kernel": name, "design": design, "dtype": dname,
                       "b": b, "w": w, "rel_err_L": errs[0],
                       "rel_err_T": errs[1] if len(errs) > 1 else None,
                       "max_abs_err": max(float((o - r).abs().max())
                                          for o, r in zip(out, ref)),
                       "tol": tol,
                       "ms": cuda_ms(torch, kern, iters=iters),
                       "plain_ms": cuda_ms(torch, plain, iters=1, warm=1),
                       "library_ms": cuda_ms(torch, lib, iters=iters),
                       "library": ("cholesky_ex + solve_triangular(L, I)"
                                   if name == "chol_inv" else
                                   "cholesky_ex"),
                       "bound_ms": bound_ms, "bound_by": by}
                timed[(name, dname, b, w)] = rec
                emit("chol_kernels", **rec)
        # an indefinite block: NaN from the failing pivot's column on, and
        # K3's NaN where its plain version has them
        for bad in NAN_PIVOTS[LEAF]:
            K = _block_spd(torch, LEAF, dtype, seed=7)
            K[bad, bad] = -1e3
            L, T = cb.chol_inv(K)
            Lp, Tp = cb.chol_inv_plain(K)
            check(torch.equal(torch.isnan(L), torch.isnan(Lp))
                  and torch.equal(torch.isnan(T), torch.isnan(Tp)),
                  f"K3 {dname}: NaN pattern at failing pivot {bad} is not "
                  f"its plain version's")
            outs = {"chol_inv_L": L, "chol_inv_T": T,
                    "cholesky_block": cb.cholesky_block(K),
                    "cholesky_panel": cb.cholesky_panel(K, 32)}
            for name, F in outs.items():
                check(bool(torch.isnan(F[bad:, bad]).all())
                      and bool(torch.isnan(F[-1, -1]))
                      and not bool(chol_ok(F)),
                      f"{name} {dname}: no NaN from an indefinite block's "
                      f"failing pivot {bad} on")
            _check_nan_mask(torch, "cholesky_block", outs["cholesky_block"],
                            cb.cholesky_block_plain(K), dname, bad)
            _check_nan_mask(torch, "cholesky_panel w=32",
                            outs["cholesky_panel"],
                            cb.cholesky_panel_plain(K, 32), dname, bad)
            emit("chol_kernels_nan", dtype=dname, b=LEAF, failing_pivot=bad,
                 nan_from_pivot_on=sorted(outs),
                 masks_equal_plain=["cholesky_block", "cholesky_panel w=32"])
        # K4's blocked form and K5's panels at b = 1024
        for bad in NAN_PIVOTS[K4_BIG]:
            K = _block_spd(torch, K4_BIG, dtype, seed=7)
            K[bad, bad] = -1e3
            _check_nan_mask(torch, "cholesky_block", cb.cholesky_block(K),
                            cb.cholesky_block_plain(K), dname, bad)
            for w in (32, 128):
                _check_nan_mask(torch, f"cholesky_panel w={w}",
                                cb.cholesky_panel(K, w),
                                cb.cholesky_panel_plain(K, w), dname, bad)
            emit("chol_kernels_nan", dtype=dname, b=K4_BIG,
                 failing_pivot=bad,
                 masks_equal_plain=["cholesky_block", "cholesky_panel w=32",
                                    "cholesky_panel w=128"])
    return timed


def _check_nan_mask(torch, name: str, L, P, dname: str, bad: int) -> None:
    """A kernel's NaN mask on an indefinite block is its plain version's
    (P), with nothing NaN (or nonzero) above the diagonal."""
    check(torch.equal(torch.isnan(L), torch.isnan(P))
          and not bool(torch.triu(L, 1).any()),
          f"{name} {dname} b={L.shape[0]}: NaN mask at failing pivot "
          f"{bad} is not its plain version's")


def _se_k(torch, X, dtype, noise: float):
    """K + noise I of the SE form at unit sf2 and lengthscales std
    sqrt(d), through K1."""
    from gp_tpu_torch.ops import se_tile
    x = torch.as_tensor(X, dtype=dtype, device="cuda")
    inv_l = 1.0 / (x.std(dim=0) * math.sqrt(x.shape[1]))
    dvals = torch.full((x.shape[0],), 1.0 + noise, dtype=dtype,
                       device="cuda")
    return se_tile.se_matrix_diag(inv_l, 1.0, x, dvals)


def phase_blocked(torch, X) -> dict:
    """The blocked factor and inverse at N = 8000 (padded once to 8192,
    block 1024, base 128) with the K3 leaf and with K4 and K5 (w = 32) as
    base_fn, against cholesky_ex + cholesky_inverse on the same K: SE at
    unit sf2, noise 0.1.  f64: blocked within 1e-9 of the library,
    relative to the largest entry (the condition number of K is ~1e5 at
    most, so both are ~1e-11 from exact).  f32: each is held to the f64
    library result, and the blocked route's error may be at most 10x the
    library's own."""
    from gp_tpu_torch.ops import blocked as bl
    from gp_tpu_torch.ops import chol_block as cb
    from gp_tpu_torch.ops.chol import blocked_factor, library_cholesky
    n = X.shape[0]
    blk = 1024
    npad = -n % blk
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    variants = {"k3_leaf": None, "k4_base": cb.cholesky_block,
                "k5_base_w32": lambda B: cb.cholesky_panel(B, 32)}
    launched = {}
    ref = None
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        K = _se_k(torch, X, dtype, 0.1)
        Llib = library_cholesky(K)
        Kilib = bl.spd_inv_library(Llib)
        if ref is None:
            ref = (Llib, Kilib)
        lib_err = {"factor": rel(Llib.double(), ref[0]),
                   "inverse": rel(Kilib.double(), ref[1])}
        rec = {"dtype": dname, "n": n, "padded": n + npad, "block": blk,
               "base_block": LEAF,
               "library": {"cholesky_ex_ms": cuda_ms(
                   torch, lambda: library_cholesky(K), iters=5, warm=2),
                   "cholesky_inverse_ms": cuda_ms(
                       torch, lambda: bl.spd_inv_library(Llib), iters=5,
                       warm=2),
                   "err_vs_f64_library": lib_err}}
        rec["library"]["total_ms"] = (rec["library"]["cholesky_ex_ms"]
                                      + rec["library"]["cholesky_inverse_ms"])
        for vname, base_fn in variants.items():
            factor = lambda: blocked_factor(K, base_fn)
            cb.reset_launches()
            L, Td, b = factor()
            check(b == blk, f"N = {n} factors in panels of {b}, not {blk}")
            Ki = bl.spd_inv_from_chol(L, block=blk, diag_inv=Td)[:n, :n]
            torch.cuda.synchronize()
            counts = dict(cb.launches)
            launched[(vname, dname)] = counts
            Ln = torch.tril(L[:n, :n])
            errs = {"factor_vs_library": rel(Ln, Llib),
                    "inverse_vs_library": rel(Ki, Kilib),
                    "factor_vs_f64_library": rel(Ln.double(), ref[0]),
                    "inverse_vs_f64_library": rel(Ki.double(), ref[1])}
            # every K3 leaf by the register kernel
            expect = {"k3_leaf": "chol_inv_reg", "k4_base": "chol",
                      "k5_base_w32": "chol_panel"}[vname]
            check(counts[expect] == LEAVES_PER_FACTOR
                  and sum(counts.values()) == LEAVES_PER_FACTOR,
                  f"blocked {vname} {dname}: launches {counts}, expected "
                  f"{LEAVES_PER_FACTOR} of {expect} and no other")
            if dname == "float64":
                check(errs["factor_vs_library"] <= 1e-9
                      and errs["inverse_vs_library"] <= 1e-9,
                      f"blocked {vname} f64 vs library: {errs}")
            else:
                check(errs["factor_vs_f64_library"]
                      <= 10 * lib_err["factor"]
                      and errs["inverse_vs_f64_library"]
                      <= 10 * lib_err["inverse"],
                      f"blocked {vname} f32: {errs} against the library's "
                      f"own {lib_err}")
            f_ms = cuda_ms(torch, factor, iters=5, warm=2)
            i_ms = cuda_ms(torch, lambda: bl.spd_inv_from_chol(
                L, block=blk, diag_inv=Td)[:n, :n], iters=5, warm=2)
            rec[vname] = {"launches": counts, "errors": errs,
                          "factor_ms": f_ms, "inverse_ms": i_ms,
                          "total_ms": f_ms + i_ms}
            del L, Td, Ki, Ln
        emit("blocked", **rec)
        del K, Llib, Kilib
        torch.cuda.empty_cache()
    return launched


def _rmse(a, b) -> float:
    import numpy as np
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


class traced_fits:
    """Records each objective evaluation's value and log sigma_n (in the
    standardized units the optimizer sees) of the fits run inside it, and
    the host clock as each evaluation starts.  The records stay on the
    card until the fit ends: no extra sync."""

    def __enter__(self):
        from gp_tpu_torch.models import exact
        self.exact, self.objective_vg = exact, exact.objective_vg
        self.rows, self.stamps = [], []

        def recorded(kernel, noise_free, vec, *rest, **kw):
            self.stamps.append(time.perf_counter())
            f, g = self.objective_vg(kernel, noise_free, vec, *rest, **kw)
            self.rows.append((f.detach(), vec.detach()))
            return f, g
        exact.objective_vg = recorded
        return self

    def __exit__(self, *exc):
        self.exact.objective_vg = self.objective_vg

    def take(self):
        """(f, log sn) per evaluation as float64 lists, and the first
        evaluation's vector (the fit's start); clears the record."""
        import torch
        f = torch.stack([r[0].double().cpu() for r in self.rows])
        ls = torch.stack([r[1][-2].double().cpu() for r in self.rows])
        vec0 = self.rows[0][1]
        self.rows = []
        return f.tolist(), ls.tolist(), vec0


def _launched(se_tile) -> dict:
    return {w: dict(by_form) for w, by_form in se_tile.launches.items()}


def phase_main_path(torch, Xtr, ytr, Xte, yte, kernel: str = "se_ard",
                    phase: str = "main_path") -> dict:
    """GP(X, y, kernel).train() and the predictions on the card, with the
    launch counts set to 0 just before and read just after: K1 and K2 of
    the kernel's form, and no other form, must carry the path."""
    import numpy as np
    from gp_tpu_torch import GP
    from gp_tpu_torch.ops import chol_block, se_tile
    from gp_tpu_torch.optim.lbfgsb import explain_result

    form = FORM_OF[kernel]
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 2**30
    se_tile.reset_launches()
    chol_block.reset_launches()
    with traced_fits() as trace:
        t0 = time.perf_counter()
        gp = GP(Xtr, ytr) if kernel == "se_ard" \
            else GP(Xtr, ytr, kernel=kernel)
        check(gp.device.type == "cuda" and gp.dtype == torch.float32,
              f"GP(X, y, kernel={kernel!r}) must default to CUDA float32")
        nll = gp.train()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    fit_s = t1 - t0
    after_train = _launched(se_tile)
    chol_train = dict(chol_block.launches)
    inf_evals = sum(1 for f, _ in trace.rows if not bool(torch.isfinite(f)))
    # host clock between evaluation starts: one evaluation and the
    # optimizer's host work; before the first, the model and NLL probes;
    # after the last, that evaluation, set_k and the final NLL.  The rate
    # from the second evaluation on leaves out one-time costs of the
    # first (lazy imports and module loads)
    gaps = np.diff(trace.stamps) * 1e3
    eval_clock = {"before_first_s": trace.stamps[0] - t0,
                  "after_last_s": t1 - trace.stamps[-1],
                  "evals_per_s_from_second": (len(trace.stamps) - 1)
                  / (t1 - trace.stamps[1]),
                  "gap_ms_median": float(np.median(gaps)),
                  "gap_ms_p90": float(np.quantile(gaps, 0.9)),
                  "gap_ms_max": float(gaps.max()),
                  "gap_max_at_eval": int(gaps.argmax()) + 2,
                  "gaps_over_100ms": int((gaps > 100).sum())}
    mem_gb = {"before": base_gb,
              "peak": torch.cuda.max_memory_allocated() / 2**30,
              "reserved": torch.cuda.memory_reserved() / 2**30}
    evals = int(gp.last_opt_result.evals)

    counts, call_s = {}, {}

    def counted(label, fn):
        before = se_tile.launches["se_matrix"][form]
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        call_s[label] = time.perf_counter() - t
        counts[label] = se_tile.launches["se_matrix"][form] - before
        return out

    t1 = time.perf_counter()
    mu, s2 = counted("batch_predict", lambda: gp.batch_predict(Xte))
    pred_s = time.perf_counter() - t1
    yg, gy = counted("batch_predict_y_with_grad",
                     lambda: gp.batch_predict_y_with_grad(Xte[:N_GRAD]))
    sg, gs = counted("batch_predict_s2_with_grad",
                     lambda: gp.batch_predict_s2_with_grad(Xte[:N_GRAD]))
    launches = _launched(se_tile)
    chol_launches = dict(chol_block.launches)

    outs = {"mu": mu, "s2": s2, "y_wg": yg, "gy": gy, "s2_wg": sg,
            "gs2": gs}
    for k, v in outs.items():
        check(bool(torch.isfinite(v).all()), f"{k} has non-finite values")
    check(tuple(mu.shape) == (N_TEST,) and tuple(gy.shape) == (N_GRAD, DIM)
          and tuple(gs.shape) == (N_GRAD, DIM), "prediction shapes")
    check(math.isfinite(nll), "final NLL not finite")
    hyp = gp.get_hyp()
    moved = float(np.max(np.abs(hyp - gp.get_default_hyps())))
    check(moved > 1e-3, "fitted hyps are the defaults")
    rmse = _rmse(mu.cpu().numpy(), yte)
    rmse_const = _rmse(np.full_like(yte, ytr.mean()), yte)
    # from the default start, gp_tpu's 160-evaluation fit on this kind of
    # data gets a held-out RMSE of about half the constant predictor's,
    # in f32 and f64 (scripts/fit_basins.py at N = 1500 and 4000); 0.6
    # fails a fit that learned nothing
    check(rmse < 0.6 * rmse_const, f"{kernel}: held-out RMSE {rmse} not "
          f"below 0.6 of the constant predictor's {rmse_const}")
    k1 = after_train["se_matrix_diag"][form]
    check(k1 >= evals, f"K1 ({form}) launched {k1} times for {evals} "
          f"objective evaluations")
    check(after_train["se_matrix"][form] >= 1,
          f"K2 ({form}) not launched in set_k")
    for label, c in counts.items():
        check(c >= 1, f"K2 ({form}) not launched in {label}")
    others = {w: {f: c for f, c in by_form.items() if f != form and c}
              for w, by_form in launches.items()}
    check(not any(others.values()),
          f"{kernel}: launches of another form on its path: {others}")
    # every K1 build (objective evaluation or NLL probe) is factored by the
    # blocked route: 64 K3 leaves each, more for set_k's tries
    check(chol_train["chol_inv_reg"] >= LEAVES_PER_FACTOR * k1,
          f"{kernel}: K3 launched {chol_train} times for {k1} "
          f"factorizations of {LEAVES_PER_FACTOR} leaves")
    # every leaf is 128 x 128, all by K3's register kernel; no K4 or K5
    check(sum(chol_launches.values()) == chol_launches["chol_inv_reg"],
          f"{kernel}: K3's rank-1 kernel, K4 or K5 launched on the main "
          f"path: {chol_launches}")
    res = {"kernel": kernel, "form": form, "nll": nll, "evals": evals,
           "fit_s": fit_s, "evals_per_s": evals / fit_s,
           "status": explain_result(gp.last_opt_result),
           "inf_evals": inf_evals,
           "rmse": rmse, "rmse_const": rmse_const,
           "predict_1000_s": pred_s, "launches": launches,
           "chol_launches": chol_launches, "chol_launches_train": chol_train,
           "launches_train": after_train, "k2_launches_by_call": counts,
           "call_s": call_s,
           "hyp_moved": moved, "hyp": hyp.tolist(),
           "eval_clock": eval_clock, "memory_gb": mem_gb}
    emit(phase, **res)
    return {"gp": gp, "nll": nll, "launches": launches, "evals": evals,
            "form": form, "chol_launches": chol_launches}


def phase_breakdown(torch, gp, phase: str = "breakdown") -> None:
    """Stages of one NLL+gradient evaluation at the fitted hyps.  The
    route the objective takes at this N is the blocked one: its factor
    (pad, blocked_cholesky with the K3 leaves) and its inverse (the
    blocked lauum); the library's cholesky_ex and cholesky_inverse are
    timed beside them on the same K.  A spec with a structured gradient
    contraction (SE) times it; any other times Q = K^-1 - alpha alpha^T
    and the vjp of the K1 build at Q, the two steps of the objective's
    generic branch."""
    from gp_tpu_torch.models.base import hyp_mean, hyp_sn2
    from gp_tpu_torch.models.exact import objective_vg
    from gp_tpu_torch.ops import blocked as bl
    from gp_tpu_torch.ops import chol as chol_mod

    kern, x, y = gp.kernel, gp._x, gp._ys
    hyp = gp._tensor(gp._hyp_to_std(gp.get_hyp()))
    nc = kern.num_hyp(x.shape[1])
    chyp, sn2, n = hyp[:nc], hyp_sn2(hyp), x.shape[0]
    check(chol_mod._use_blocked(n, x.device),
          f"N = {n} on {x.device} does not take the blocked route")
    K = kern.k_noise(chyp, sn2, x, n)
    factor = lambda: chol_mod.blocked_factor(K)
    L, Td, blk = factor()
    _, Kinv = chol_mod.factor_and_inverse(K)
    Llib = chol_mod.library_cholesky(K)
    r = y - hyp_mean(hyp)
    alpha = Kinv @ r
    vec = gp._tensor(gp._hyp_to_std(gp.get_hyp()))
    stages = {
        "k1_build": lambda: kern.k_noise(chyp, sn2, x, n),
        "route_blocked_factor": factor,
        "route_blocked_inverse": lambda: bl.spd_inv_from_chol(
            L, block=blk, diag_inv=Td)[:n, :n],
        "library_cholesky_ex": lambda: chol_mod.library_cholesky(K),
        "library_cholesky_inverse": lambda: bl.spd_inv_library(Llib),
        "alpha_matvec": lambda: Kinv @ r,
    }
    if kern.k_noise_vjp_q is not None:
        stages["grad_contraction"] = lambda: kern.k_noise_vjp_q(
            chyp, sn2, x, n, K, Kinv, alpha)
    else:
        leaves = (chyp.detach().requires_grad_(True),
                  sn2.detach().requires_grad_(True))
        with torch.enable_grad():
            K_build = kern.k_noise(*leaves, x, n)
        Q = torch.addr(Kinv, alpha, alpha, alpha=-1.0)
        # the objective writes Q over K^-1 in place: the same bytes
        stages["q_form"] = lambda: torch.addr(Kinv, alpha, alpha,
                                              alpha=-1.0)
        stages["generic_vjp"] = lambda: torch.autograd.grad(
            K_build, leaves, Q, retain_graph=True)
    stages["objective_total"] = lambda: objective_vg(kern, False, vec, x, y)
    ms = {k: cuda_ms(torch, f, iters=5, warm=1) for k, f in stages.items()}
    # the build's device time without launch gaps, and the host's enqueue
    # of the k_noise call (its torch ops and the launch) beside it
    ms["k1_build_device"] = graph_ms(torch, stages["k1_build"])
    ms["k1_build_host"] = host_ms(torch, stages["k1_build"])
    ms["route_blocked_total"] = (ms["route_blocked_factor"]
                                 + ms["route_blocked_inverse"])
    ms["library_total"] = (ms["library_cholesky_ex"]
                           + ms["library_cholesky_inverse"])
    # one evaluation as a fit runs it (ending in a synchronize), on this
    # route and on the library route: the host's enqueue time, the wall
    # time, and the back-to-back CUDA-event time
    per_eval = {route: eval_clock(torch, lambda b=b: objective_vg(
        kern, False, vec, x, y, blocked=b))
        for route, b in (("blocked", True), ("library", False))}
    # device memory one evaluation takes beyond what is already held
    del L, Td, Llib
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    objective_vg(kern, False, vec, x, y)
    torch.cuda.synchronize()
    extra_gb = (torch.cuda.max_memory_allocated() - held) / 2**30
    emit(phase, kernel=kern.name, n=n, dtype=str(x.dtype).split(".")[-1],
         ms=ms, objective_per_route_ms=per_eval,
         objective_extra_memory_gb=extra_gb)


# the sizes at which route_sweep times both routes; chol._BLOCKED_MIN_N
# is set from its runs
SWEEP_N = (1024, 2048, 3072, 4096, 6144, 8000)


def phase_route_sweep(torch, gp, Xtr, ytr) -> None:
    """One SE-ARD objective evaluation (objective_vg) on the blocked route
    and on the library route, at the first N rows of the training data
    for each N in SWEEP_N, float32 and float64, at the f32 fit's hyps:
    eval_clock's host enqueue, synced wall and back-to-back times.  Prints
    the route each N takes by default and the one whose synced wall time
    (a fit's evaluation) was lower; checks nothing but that both ran."""
    from gp_tpu_torch.models.exact import objective_vg
    from gp_tpu_torch.ops import chol as chol_mod
    from gp_tpu_torch.utils.convert import gp_from_state
    rows = []
    for dname in ("float32", "float64"):
        for n in SWEEP_N:
            g = gp_from_state({"x": Xtr[:n], "y": ytr[:n],
                               "hyps": gp.get_hyp(), "kernel": "se_ard",
                               "dtype": dname}, device="cuda")
            vec = g._tensor(g._hyp_to_std(g.get_hyp()))
            clocks = {route: eval_clock(torch, lambda b=b: objective_vg(
                g.kernel, False, vec, g._x, g._ys, blocked=b))
                for route, b in (("blocked", True), ("library", False))}
            wall = {r: c["synced_wall_ms"] for r, c in clocks.items()}
            rows.append({"dtype": dname, "n": n,
                         "default_route": "blocked" if chol_mod._use_blocked(
                             n, g._x.device) else "library",
                         "faster_synced": min(wall, key=wall.get),
                         "blocked_over_library_synced": wall["blocked"]
                         / wall["library"], **clocks})
            del g, vec
            torch.cuda.empty_cache()
    emit("route_sweep", kernel="se_ard", blocked_min_n=chol_mod._BLOCKED_MIN_N,
         rows=rows)


def _projected_grad(torch, gp, vec, g) -> float:
    from gp_tpu_torch.optim.lbfgsb import projected_gradient
    lb, ub = (torch.as_tensor(b, dtype=g.dtype, device=g.device)
              for b in gp._std_bounds())
    return float(projected_gradient(vec, g, lb, ub))


def phase_f64(torch, Xtr, ytr, Xte, yte, gp32, nll32: float) -> object:
    """The same fit in f64 on the card (through the f64 kernels), the f32
    objective against the f64 one at the f32 fit's hyps, and where the
    two fits' trajectories part.

    The two fits need not end within 1e-3 of each other: from the default
    start the objective has more than one basin, and on this data the f32
    and f64 trajectories end in different ones.  This phase prints how
    each fit stopped, the f64 gradient at the f32 end point, and the first
    evaluation at which the two objectives part.  It checks the f32
    objective against the f64 one at the same hyps (1e-3): f32 must not
    move the NLL it reports."""
    from gp_tpu_torch import GP
    from gp_tpu_torch.models import exact
    from gp_tpu_torch.models.exact import objective_vg
    from gp_tpu_torch.ops import chol_block, se_tile
    from gp_tpu_torch.optim.lbfgsb import explain_result, lbfgsb_impl

    se_tile.reset_launches()
    chol_block.reset_launches()
    with traced_fits() as trace:
        t0 = time.perf_counter()
        gp = GP(Xtr, ytr, dtype=torch.float64)
        nll = gp.train()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _launched(se_tile)
        chol_launches = dict(chol_block.launches)
        f64, ls64, vec0 = trace.take()
        # the f32 fit again, for its trajectory (the main path's run is
        # left as a user runs it)
        again = GP(Xtr, ytr)
        nll32_again = again.train()
        f32, ls32, _ = trace.take()
        # the f64 fit from the same start on the library route (exact.fit's
        # loop, objective forced onto that route): where the two routes'
        # trajectories part
        lb, ub = (torch.as_tensor(b, dtype=torch.float64, device="cuda")
                  for b in gp._std_bounds())
        lib = lbfgsb_impl(lambda v: exact.objective_vg(
            gp.kernel, False, v, gp._x, gp._ys, blocked=False), vec0, lb, ub,
            max_evals=gp._MAX_EVAL)
        f64lib, ls64lib, _ = trace.take()
    # the optimizer's f is in standardized units (base.GPBase.train)
    to_nll = lambda f: float(f) + N_TRAIN * math.log(gp._y_sigma)
    evals = int(gp.last_opt_result.evals)
    nll64_at_32 = gp.nll(gp32.get_hyp())
    rel = abs(nll32 - nll64_at_32) / abs(nll64_at_32)
    mu, _ = gp.batch_predict(Xte)

    # how the f32 fit stopped, and the f64 objective at its end point
    r32 = gp32.last_opt_result
    vec32 = r32.x.double()
    _, g_at = objective_vg(gp.kernel, False, vec32, gp._x, gp._ys)
    apart = lambda fa, fb, tol: next(
        (i + 1 for i, (a, b) in enumerate(zip(fa, fb))
         if not abs(a - b) <= tol * abs(b)), None)

    def pick(f, ls):
        evs = sorted({i for i in (1, 10, 20, 40, 80, 120, 150)
                      if i <= len(f)} | {len(f)})
        return {"eval": evs, "f_std": [f[i - 1] for i in evs],
                "log_sn_std": [ls[i - 1] for i in evs]}
    emit("f64_fit", nll=nll, evals=evals, fit_s=fit_s, launches=launches,
         chol_launches=chol_launches,
         status=explain_result(gp.last_opt_result),
         rmse=_rmse(mu.cpu().numpy(), yte), hyp=gp.get_hyp().tolist(),
         hyp_f32=gp32.get_hyp().tolist(), nll_f32=nll32,
         status_f32=explain_result(r32),
         projected_grad_f32=_projected_grad(torch, gp32, r32.x, r32.g),
         projected_grad_f64_at_f32_end=_projected_grad(torch, gp, vec32,
                                                       g_at),
         grad_f64_at_f32_end=g_at.tolist(),
         nll_f64_at_f32_hyps=nll64_at_32, rel_gap_at_f32_hyps=rel,
         rel_gap_of_fits=abs(nll32 - nll) / abs(nll),
         fits_within_1e3=abs(nll32 - nll) <= 1e-3 * abs(nll),
         nll_f32_refit=nll32_again,
         first_eval_apart={"1e-6": apart(f32, f64, 1e-6),
                           "1e-3": apart(f32, f64, 1e-3)},
         library_route_f64={
             "nll_opt": to_nll(lib.f),
             "nll_opt_blocked": float(gp.last_opt_result.f),
             "evals": int(lib.evals), "status": explain_result(
                 lib._replace(f=to_nll(lib.f))),
             "first_eval_apart_from_blocked": {
                 t: apart(f64lib, f64, float(t))
                 for t in ("1e-12", "1e-9", "1e-6", "1e-3")}},
         trajectory={"f32": pick(f32, ls32), "f64": pick(f64, ls64),
                     "f64_library": pick(f64lib, ls64lib)})
    check(math.isfinite(nll), "f64 NLL not finite")
    check(launches["se_matrix_diag"]["se"] >= evals,
          "f64 fit did not go through the f64 K1 kernel")
    check(chol_launches["chol_inv_reg"] >= LEAVES_PER_FACTOR * evals
          and sum(chol_launches.values()) == chol_launches["chol_inv_reg"],
          f"f64 fit: chol_block launches {chol_launches} for {evals} "
          f"evaluations: not all by K3's register kernel")
    check(rel <= 1e-3, f"f32 NLL {nll32} not within 1e-3 of the f64 NLL "
          f"{nll64_at_32} at the same hyps")
    return gp


def phase_fd(torch, gp64, Xte, phase: str = "fd_check") -> None:
    """Central differences in f64 against the returned input gradients."""
    import numpy as np
    pts = np.asarray(Xte[:4], np.float64)
    h = 1e-4
    _, gy = gp64.batch_predict_y_with_grad(pts)
    _, gs = gp64.batch_predict_s2_with_grad(pts)
    gy, gs = gy.cpu().numpy(), gs.cpu().numpy()
    e = np.eye(DIM) * h
    plus = (pts[:, None, :] + e[None]).reshape(-1, DIM)
    minus = (pts[:, None, :] - e[None]).reshape(-1, DIM)
    fd_y = ((gp64.batch_predict_y(plus) - gp64.batch_predict_y(minus))
            .cpu().numpy().reshape(4, DIM) / (2 * h))
    fd_s = ((gp64.batch_predict_s2(plus) - gp64.batch_predict_s2(minus))
            .cpu().numpy().reshape(4, DIM) / (2 * h))
    rel = lambda g, fd: float(np.max(np.linalg.norm(g - fd, axis=1)
                                     / np.linalg.norm(fd, axis=1)))
    ry, rs = rel(gy, fd_y), rel(gs, fd_s)
    emit(phase, kernel=gp64.kernel.name, h=h, rel_err_y=ry, rel_err_s2=rs,
         tol=1e-5)
    check(ry <= 1e-5 and rs <= 1e-5,
          f"{gp64.kernel.name} input gradients vs central differences: "
          f"{ry}, {rs} > 1e-5")


def parity_hyps(fit_hyp, kernel: str, ytr):
    """Hyps for `kernel` from its family's ARD fit on the card: an iso
    spec takes the mean log lengthscale, and the noise is raised to at
    least 0.1 std(y), so that the posteriors compared are well
    conditioned (the f32 fits end with the noise at its 1e-3 floor)."""
    import numpy as np
    h = np.array(fit_hyp, np.float64)
    if kernel.endswith("_iso"):
        h = np.concatenate([[h[:DIM].mean()], h[DIM:]])
    h[-2] = max(h[-2], math.log(0.1 * float(np.std(ytr))))
    return h


def phase_cpu_parity(torch, gp64, paths, Xtr, ytr, Xte) -> None:
    """The card against the CPU (plain versions, LAPACK) in f64, on a
    600-point posterior: se_ard at the f64 fit's hyps, each Matern/RQ
    spec at its family's fitted hyps (parity_hyps)."""
    import numpy as np
    from gp_tpu_torch.utils.convert import gp_from_state
    hyps = {"se_ard": gp64.get_hyp()}
    for kernel in NEW_SPECS:
        family = kernel.removesuffix("_iso")
        hyps[kernel] = parity_hyps(paths[family]["gp"].get_hyp(), kernel,
                                   ytr)
    pts = Xte[:200]
    rel = lambda a, b: float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
    errs = {}
    for kernel, h in hyps.items():
        state = {"x": Xtr[:600], "y": ytr[:600], "hyps": h,
                 "kernel": kernel, "dtype": "float64"}
        gc = gp_from_state(state, device="cuda")
        gh = gp_from_state(state, device="cpu")
        e = {"nll": abs(gc.nll() - gh.nll()) / abs(gh.nll())}
        for name in ("batch_predict", "batch_predict_y_with_grad",
                     "batch_predict_s2_with_grad"):
            for i, (a, b) in enumerate(zip(getattr(gc, name)(pts),
                                           getattr(gh, name)(pts))):
                e[f"{name}[{i}]"] = rel(a.cpu().numpy(), b.numpy())
        errs[kernel] = e
    worst = max(v for e in errs.values() for v in e.values())
    emit("cpu_parity", n=600, rel_err=errs, max_rel_err=worst, tol=1e-8)
    check(worst <= 1e-8, f"card vs CPU (f64) beyond 1e-8: {errs}")


def phase_blocked_vs_library(torch, gp64, paths, Xtr, ytr) -> None:
    """The objective through the blocked route (K3 leaves, blocked lauum)
    against the library route (cholesky_ex, cholesky_inverse) on the
    card, f64, N = 8000: SE-ARD at the f64 fit's hyps, Matern-5/2 at its
    fit's hyps with the noise raised as in cpu_parity (parity_hyps).
    Value and gradient within 1e-9, relative to |value| and to the
    largest gradient entry."""
    from gp_tpu_torch.models.exact import nll_vg_raw
    from gp_tpu_torch.ops import chol_block
    from gp_tpu_torch.utils.convert import gp_from_state
    hyps = {"se_ard": gp64.get_hyp(),
            "matern52": parity_hyps(paths["matern52"]["gp"].get_hyp(),
                                    "matern52", ytr)}
    res = {}
    for kernel, h in hyps.items():
        gp = gp_from_state({"x": Xtr, "y": ytr, "hyps": h, "kernel": kernel,
                            "dtype": "float64"}, device="cuda")
        hyp = gp._tensor(gp._hyp_to_std(gp.get_hyp()))
        chol_block.reset_launches()
        fb, gb = nll_vg_raw(gp.kernel, hyp, gp._x, gp._ys)
        torch.cuda.synchronize()
        k3 = chol_block.launches["chol_inv_reg"]
        fl, gl = nll_vg_raw(gp.kernel, hyp, gp._x, gp._ys, blocked=False)
        res[kernel] = {
            "nll_blocked": float(fb), "nll_library": float(fl),
            "rel_value": abs(float(fb - fl)) / abs(float(fl)),
            "rel_grad": float((gb - gl).abs().max() / gl.abs().max()),
            "k3_launches": k3}
        check(k3 == LEAVES_PER_FACTOR,
              f"{kernel}: blocked objective ran {k3} K3 leaves")
        del gp
    worst = max(max(r["rel_value"], r["rel_grad"]) for r in res.values())
    emit("blocked_vs_library", n=Xtr.shape[0], dtype="float64", rel=res,
         max_rel=worst, tol=1e-9)
    check(worst <= 1e-9, f"blocked vs library objective beyond 1e-9: {res}")


class stamped:
    """Records the host clock at each call of module.name (a function the
    fit looks up at call time) inside the block."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.stamps = []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(*a, **kw):
            self.stamps.append(time.perf_counter())
            return self.orig(*a, **kw)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def phase_global_search(torch, Xtr, ytr, Xte, yte) -> dict:
    """The MVMO global search (select_init_hyp) on the card, SE-ARD f32 at
    N = 8000, d = 24, num = num_hyp * 50 candidates from the defaults,
    each chunk of candidates one by one on the blocked route: one K1 build
    and one blocked factor (64 K3 leaves) per candidate, counted exactly.
    The fit from the search's best point must beat 0.6 of the constant
    predictor's held-out RMSE.  Then GP.train from gp_tpu's INF start
    (tests/test_mvmo.py:63-65, every length scale at -200: 1/l overflows
    float32), with the launch counts set to 0 again: it must enter the
    search, end finite and no higher than the search's best point (+ 1e-3
    |NLL|), and predict no worse than the constant predictor (+ 1e-3).
    0.6 of the constant's RMSE is not asked of it: from that start no
    archive point is better than the white-noise optimum's plateau, whose
    near-ties rounding orders, and gp_tpu's own search and train() end on
    the plateau there too (scripts/search_parity.py, PERF.md §6)."""
    import numpy as np
    from gp_tpu_torch import GP
    from gp_tpu_torch.ops import chol_block, se_tile
    from gp_tpu_torch.optim.lbfgsb import explain_result
    from gp_tpu_torch.optim.multistart import mvmo_evaluations

    gp = GP(Xtr, ytr)
    defaults = gp.get_default_hyps()
    num, chunk = gp.num_hyp * 50, gp._multistart_chunk()
    cands = mvmo_evaluations(num, chunk)
    log_sigma_n = N_TRAIN * math.log(gp._y_sigma)   # std -> original NLL
    f_def = float(gp._multistart_objective()(
        gp._tensor(gp._hyp_to_std(defaults))[None])[0])
    se_tile.reset_launches()
    chol_block.reset_launches()
    t0 = time.perf_counter()
    hyps = gp.select_init_hyp(num, defaults)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    k1_search = se_tile.launches["se_matrix_diag"]["se"]
    chol_search = dict(chol_block.launches)
    best_f, evaluated = gp.last_search
    check(evaluated == cands, f"search reports {evaluated} evaluations, "
          f"expected {cands}")
    check(k1_search == cands, f"search: K1 launched {k1_search} times for "
          f"{cands} candidates")
    check(chol_search["chol_inv_reg"] == LEAVES_PER_FACTOR * cands
          and sum(chol_search.values()) == chol_search["chol_inv_reg"],
          f"search: chol_block launches {chol_search} for {cands} "
          f"candidates of {LEAVES_PER_FACTOR} leaves")
    check(math.isfinite(best_f) and best_f <= f_def,
          f"search best f {best_f} not finite or above the defaults' {f_def}")
    # the fit from the search's best point: what the search is for
    g1 = GP(Xtr, ytr)
    nll_best = g1.train(hyps)
    mu, _ = g1.batch_predict(Xte)
    rmse_best = _rmse(mu.cpu().numpy(), yte)
    rmse_const = _rmse(np.full_like(yte, ytr.mean()), yte)
    emit("global_search", n=N_TRAIN, d=DIM, dtype="float32", num=num,
         chunk=chunk, candidates=cands, seconds=search_s,
         candidates_per_s=cands / search_s, best_f_std=best_f,
         f_defaults_std=f_def, best_nll=best_f + log_sigma_n,
         nll_defaults=f_def + log_sigma_n, k1_launches=k1_search,
         chol_launches=chol_search, best_hyp=hyps.tolist(),
         fit_from_best={"nll": nll_best,
                        "evals": int(g1.last_opt_result.evals),
                        "status": explain_result(g1.last_opt_result),
                        "rmse": rmse_best, "rmse_const": rmse_const})
    check(math.isfinite(nll_best) and rmse_best < 0.6 * rmse_const,
          f"fit from the search's best: NLL {nll_best}, held-out RMSE "
          f"{rmse_best} not below 0.6 of the constant predictor's "
          f"{rmse_const}")
    del g1

    bad = defaults.copy()
    bad[:DIM] = -200.0
    g2 = GP(Xtr, ytr)
    check(g2.nll(bad) == math.inf, "the start with length scales at -200 "
          "is not INF in float32")
    se_tile.reset_launches()
    chol_block.reset_launches()
    t0 = time.perf_counter()
    nll = g2.train(bad)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    check(g2.last_search is not None, "train(bad) did not enter the search")
    check(math.isfinite(nll), "train(bad): final NLL not finite")
    mu, _ = g2.batch_predict(Xte)
    torch.cuda.synchronize()
    launches = _launched(se_tile)
    chol_launches = dict(chol_block.launches)
    rmse = _rmse(mu.cpu().numpy(), yte)
    search_nll = g2.last_search[0] + log_sigma_n
    emit("global_search_train_from_inf", nll=nll, seconds=train_s,
         search_best_f_std=g2.last_search[0], search_best_nll=search_nll,
         evals=int(g2.last_opt_result.evals),
         status=explain_result(g2.last_opt_result), rmse=rmse,
         rmse_const=rmse_const, hyp=g2.get_hyp().tolist(),
         launches=launches, chol_launches=chol_launches)
    check(nll <= search_nll + 1e-3 * abs(search_nll), f"train(bad): NLL "
          f"{nll} above the search's best point's {search_nll}")
    check(rmse <= (1 + 1e-3) * rmse_const, f"train(bad): held-out RMSE "
          f"{rmse} worse than the constant predictor's {rmse_const}")
    return {"search": {"k1": k1_search, "k3": chol_search["chol_inv_reg"]},
            "train_from_inf": {"k1": launches["se_matrix_diag"]["se"],
                               "k3": chol_launches["chol_inv_reg"]}}


def phase_multistart(torch, Xtr, ytr, main) -> dict:
    """GP(X, y).train_multistart(n_starts=4) on the card (SE-ARD f32):
    start 0 is the clipped default start that train() takes, so the best
    NLL must be at most the main path's + 1e-3 |NLL|."""
    from gp_tpu_torch import GP
    from gp_tpu_torch.ops import chol_block, se_tile

    se_tile.reset_launches()
    chol_block.reset_launches()
    t0 = time.perf_counter()
    gp = GP(Xtr, ytr)
    nll = gp.train_multistart(n_starts=4)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launched(se_tile)
    chol_launches = dict(chol_block.launches)
    res = gp.last_multistart
    log_sigma_n = N_TRAIN * math.log(gp._y_sigma)
    all_nll = [float(f) + log_sigma_n for f in res.all_f.double().cpu()]
    main_res = main["gp"].last_opt_result
    limit = main["nll"] + 1e-3 * abs(main["nll"])
    emit("multistart", n=N_TRAIN, d=DIM, dtype="float32", n_starts=4,
         seconds=secs, evals=res.evals, total_evals=sum(res.evals),
         evals_per_s=sum(res.evals) / secs, start_nll_opt=all_nll,
         best_start=int(torch.argmin(res.all_f)), nll=nll,
         main_path_nll=main["nll"], start0_end_equals_main_path_end=bool(
             torch.equal(res.all_x[0], main_res.x)),
         start0_evals_main_path_evals=[res.evals[0], int(main_res.evals)],
         limit=limit,
         launches=launches, chol_launches=chol_launches)
    check(math.isfinite(nll) and nll <= limit,
          f"multistart NLL {nll} above the single start's {main['nll']} + "
          f"1e-3 |NLL|")
    check(launches["se_matrix_diag"]["se"] >= sum(res.evals),
          f"multistart: K1 launched {launches} for {sum(res.evals)} "
          f"evaluations")
    return {"launches": launches, "chol_launches": chol_launches}


N_INDUCING = 512


def _k2_f64_record(torch, se_tile, x1, x2, inv_l, sf2) -> dict:
    """K2 at (x1, x2) in float64 against its plain version (each entry
    within its rounding bound), times back to back and from a CUDA graph,
    the plain version's and the bound."""
    m, n, d = x1.shape[0], x2.shape[0], x1.shape[1]
    kern = lambda: se_tile.se_matrix(inv_l, sf2, x1, x2)
    plain = lambda: se_tile.se_matrix_plain(inv_l, sf2, x1, x2)
    out, ref = kern(), plain()
    bound = se_tile.rounding_bound(inv_l, sf2, x1, x2, ref)
    err = (out - ref).abs()
    # an exact entry is within any bound, 0 included (at a tiny sf2 the
    # bound's sf2 * tiny term underflows to 0)
    ratio = float(torch.where(err == 0, 0.0, err / bound).max())
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"se_tile f64 {m}x{n}x{d}: off by {ratio} times its rounding bound")
    bound_ms, by = se_bound_ms(m, n, d, "float64", False)
    return {"m": m, "n": n, "d": d, "max_abs_err": float(err.max()),
            "max_err_over_bound": ratio, "ms": cuda_ms(torch, kern),
            "device_ms": graph_ms(torch, kern),
            "plain_ms": cuda_ms(torch, plain, iters=5),
            "bound_ms": bound_ms, "bound_by": by}


# Card-against-CPU gradient limits at each sparse model's fitted hyps, set
# from scripts/sparse_sensitivity.py on the card at this path's N = 8000,
# M = 512 (PERF.md §6): K2's entries moved by 2e-16 move FITC's gradient
# there by up to 1.7e-5 of its largest entry, so the gap is held to ten
# times that.  VFE's fit ends at its noise-only optimum (sf2 ~ 1e-30): K2
# is ~0 and moving it moves nothing, and the gradient is ~0 (largest entry
# 1.6e-11), so a gap relative to it is rounding over nothing (0.07 read on
# the card, 1.1e-12 absolute): there the gap is held relative to |f|, to
# 1e-12, a hundred times the f64 rounding (1e-16 |f|) of the O(N) terms
# that cancel in it.
FITTED_GRAD_LIMIT = {"FITC": ("grad", 2e-4), "VFE": ("grad_over_f", 1e-12)}


def phase_sparse(torch, Xtr, ytr, Xte, yte, model: str,
                 fd_hyps=None) -> dict:
    """FITC or VFE on the card, float64 by default, N = 8000, d = 24, the
    last 512 training rows as inducing points (gp_tpu's CLI): train(),
    predictions, one objective evaluation's clock, K2 (Kuu, Kxu, K(X*, U))
    launches and no K1 or K3, K2 f64 at the path's shapes against its
    plain version; the CPU port's value and NLL within 1e-8 and gradient
    within FITTED_GRAD_LIMIT at the fitted hyps, all three within 1e-8 with
    the noise raised; input gradients against central differences, at the
    fitted hyps or at fd_hyps.  The RMSE is printed, not checked: from the
    defaults VFE may end at its noise-only optimum (the constant
    predictor), as gp_tpu's VFE does; there K(X*, U) underflows and the
    input gradients are zero to rounding, so main() checks VFE's input
    gradients, and times its K2, at FITC's fitted hyps (fd_hyps), an
    informative posterior."""
    import numpy as np
    import gp_tpu_torch
    from gp_tpu_torch.models import sparse
    from gp_tpu_torch.ops import chol_block, se_tile
    from gp_tpu_torch.optim.lbfgsb import explain_result
    from gp_tpu_torch.utils.convert import gp_from_state

    phase = f"sparse_{model.lower()}"
    se_tile.reset_launches()
    chol_block.reset_launches()
    with stamped(sparse, "value_and_grad") as st:
        t0 = time.perf_counter()
        m = getattr(gp_tpu_torch, model)(Xtr, ytr)
        check(m.device.type == "cuda" and m.dtype == torch.float64,
              f"{model}(X, y) must default to CUDA float64")
        m.set_inducing(Xtr[-N_INDUCING:])
        nll = m.train()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    evals = int(m.last_opt_result.evals)
    check(len(st.stamps) == evals, f"{model}: {len(st.stamps)} objective "
          f"calls for {evals} evaluations")
    train_launches = _launched(se_tile)
    t2 = time.perf_counter()
    mu, _ = m.batch_predict(Xte)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t2
    launches = _launched(se_tile)
    chol_launches = dict(chol_block.launches)
    k2 = train_launches["se_matrix"]["se"]
    check(k2 >= 2 * evals, f"{model}: K2 launched {k2} times for {evals} "
          f"evaluations")
    check(sum(launches["se_matrix_diag"].values()) == 0
          and sum(v for f, v in launches["se_matrix"].items() if f != "se")
          == 0 and sum(chol_launches.values()) == 0,
          f"{model}: K1, K3-K5 or another form on the path: {launches}, "
          f"{chol_launches}")
    check(math.isfinite(nll), f"{model}: final NLL not finite")
    rmse = _rmse(mu.cpu().numpy(), yte)
    rmse_const = _rmse(np.full_like(yte, ytr.mean()), yte)

    # one evaluation at the fitted hyps: its K2 launches by form, its clock
    fun = m._objective_closure()
    vec = m._tensor(m._hyp_to_std(m.get_hyp()))
    se_tile.reset_launches()
    f_card, g_card = fun(vec)
    torch.cuda.synchronize()
    per_eval = _launched(se_tile)
    check(per_eval["se_matrix"]["se"] == 2
          and sum(per_eval["se_matrix_diag"].values()) == 0,
          f"{model}: one evaluation launched {per_eval}, expected K2 twice "
          f"(Kuu, Kxu)")
    clock = eval_clock(torch, lambda: fun(vec))

    # the hyps of the checks below: the fitted ones, or fd_hyps (at VFE's
    # noise-only optimum sf2 ~ 1e-30: K(X*, U) underflows, the rounding
    # bound's sf2 * tiny too, and the gradient is ~0 at convergence, so
    # its card-vs-CPU gap reads 0.07 of its largest entry, 1.1e-12
    # absolute, 1.0e-16 of |f|: FITTED_GRAD_LIMIT holds it on |f|)
    probe_hyps = m.get_hyp() if fd_hyps is None else fd_hyps

    # the CPU port against the card, float64, at the fitted hyps and at the
    # probe hyps with the noise raised to 0.1 std(y) (parity_hyps, as
    # cpu_parity does for the exact GP).  The value and NLL are held to
    # 1e-8 at both points, the gradient to 1e-8 at the raised noise and to
    # FITTED_GRAD_LIMIT at the fitted hyps, where the objective amplifies
    # the kernels' last-bit rounding (scripts/sparse_sensitivity.py)
    parity = {}
    for label, h in (("fitted", m.get_hyp()),
                     ("noise_raised", parity_hyps(probe_hyps, "se_ard",
                                                  ytr))):
        state = {"model": model, "x": Xtr, "y": ytr, "hyps": h,
                 "dtype": "float64", "inducing": Xtr[-N_INDUCING:],
                 "jitter_u": m._jitter_u}
        pair = [gp_from_state(state, device=d) for d in ("cuda", "cpu")]
        (fc, gc), (fh, gh) = (p._objective_closure()(
            p._tensor(p._hyp_to_std(h))) for p in pair)
        nc, nh = pair[0].nll(), pair[1].nll()
        gap = float((gc.cpu() - gh).abs().max())
        parity[label] = {
            "value": abs(float(fc) - float(fh)) / abs(float(fh)),
            "grad": gap / float(gh.abs().max()),
            "grad_over_f": gap / abs(float(fh)), "nll": abs(nc - nh) / abs(nh)}
        del pair
    # K2 in float64 at the path's shapes, at the length scales of the fd
    # check
    chyp = m._tensor(probe_hyps)[:DIM + 1]
    inv_l, sf2 = torch.exp(-chyp[:DIM]), torch.exp(2.0 * chyp[DIM])
    u = m.inducing
    k2_rec = {"kxu": _k2_f64_record(torch, se_tile, m.train_in, u, inv_l,
                                    sf2),
              "kuu": _k2_f64_record(torch, se_tile, u, u, inv_l, sf2)}
    gaps = np.diff(st.stamps)
    emit(phase, model=model, n=N_TRAIN, m=N_INDUCING, d=DIM,
         dtype="float64", nll=nll, evals=evals,
         status=explain_result(m.last_opt_result, m._MAX_EVAL),
         fit_s=t1 - t0,
         evals_per_s_from_second=(len(st.stamps) - 1) / (t1 - st.stamps[1]),
         gap_ms_median=float(np.median(gaps) * 1e3),
         objective_clock_ms=clock, jitter_u=m._jitter_u, rmse=rmse,
         rmse_const=rmse_const, predict_1000_s=pred_s,
         k2_launches_train=k2, k2_launches_per_eval=per_eval["se_matrix"],
         launches=launches, chol_launches=chol_launches,
         envelope_budget_bytes=sparse.hbm_budget_bytes(m.device),
         envelope_estimate_bytes=sparse.SPARSE_PANEL_FACTOR * N_TRAIN
         * N_INDUCING * 8,
         cpu_parity={**parity, "tol": 1e-8,
                     "fitted_grad_limit": FITTED_GRAD_LIMIT[model]},
         k2_f64=k2_rec,
         hyp=m.get_hyp().tolist(),
         fd_check_hyps="fitted" if fd_hyps is None else "given")
    checked = [parity["fitted"]["value"], parity["fitted"]["nll"],
               *parity["noise_raised"].values()]
    check(max(checked) <= 1e-8, f"{model}: card vs CPU beyond 1e-8: "
          f"{parity}")
    measure, limit = FITTED_GRAD_LIMIT[model]
    check(parity["fitted"][measure] <= limit, f"{model}: card vs CPU "
          f"gradient at the fitted hyps, {measure} "
          f"{parity['fitted'][measure]} beyond {limit}")
    fd_model = m if fd_hyps is None else gp_from_state(
        {"model": model, "x": Xtr, "y": ytr, "hyps": probe_hyps,
         "dtype": "float64", "inducing": Xtr[-N_INDUCING:],
         "jitter_u": m._jitter_u}, device="cuda")
    phase_fd(torch, fd_model, Xte, f"fd_check_{model.lower()}")
    return {"launches": launches, "k2": k2_rec, "hyp": m.get_hyp()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import gp_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: gp_tpu_torch not found beside the script: "
              f"{exc}", file=sys.stderr)
        return 2
    from gp_tpu_torch.utils.convert import gp_from_state
    from gp_tpu_torch.utils.synth import make_data
    try:
        dev = phase_device(torch)
        phase_build()
        X, y = make_data(N_TRAIN + N_TEST, d=DIM, seed=SEED)
        Xtr, ytr, Xte, yte = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], \
            y[N_TRAIN:]
        timed = phase_kernels(torch, Xtr)
        phase_big_index(torch)
        chol_timed = phase_chol_kernels(torch)
        blocked_launches = phase_blocked(torch, Xtr)
        paths = {"se_ard": phase_main_path(torch, Xtr, ytr, Xte, yte)}
        phase_breakdown(torch, paths["se_ard"]["gp"])
        phase_route_sweep(torch, paths["se_ard"]["gp"], Xtr, ytr)
        gp64 = phase_f64(torch, Xtr, ytr, Xte, yte, paths["se_ard"]["gp"],
                         paths["se_ard"]["nll"])
        phase_fd(torch, gp64, Xte)
        paths["matern52"] = phase_main_path(torch, Xtr, ytr, Xte, yte,
                                            "matern52", "main_path_matern52")
        phase_breakdown(torch, paths["matern52"]["gp"], "breakdown_matern52")
        gpm64 = gp_from_state(
            {"x": Xtr, "y": ytr, "kernel": "matern52", "dtype": "float64",
             "hyps": parity_hyps(paths["matern52"]["gp"].get_hyp(),
                                 "matern52", ytr)}, device="cuda")
        phase_fd(torch, gpm64, Xte, "fd_check_matern52")
        del gpm64
        for kernel in ("matern32", "rq"):
            paths[kernel] = phase_main_path(torch, Xtr, ytr, Xte, yte,
                                            kernel, f"main_path_{kernel}")
        phase_cpu_parity(torch, gp64, paths, Xtr, ytr, Xte)
        phase_blocked_vs_library(torch, gp64, paths, Xtr, ytr)
        search = phase_global_search(torch, Xtr, ytr, Xte, yte)
        multi = phase_multistart(torch, Xtr, ytr, paths["se_ard"])
        sparse = {"FITC": phase_sparse(torch, Xtr, ytr, Xte, yte, "FITC")}
        sparse["VFE"] = phase_sparse(torch, Xtr, ytr, Xte, yte, "VFE",
                                     fd_hyps=sparse["FITC"]["hyp"])
        src = "gp_tpu_torch/csrc/se_tile.cu"
        kernels = []
        for kernel, path in paths.items():
            form = path["form"]
            for sym, wrapper, line in ((True, "se_matrix_diag", 89),
                                       (False, "se_matrix", 71)):
                name = kernel_name(form, sym)
                rec = timed[(name, "float32", 0.7 if form == "rq" else 1.0)]
                launches = path["launches"][wrapper][form]
                check(launches > 0, f"{name} was not launched on the "
                      f"{kernel} main path")
                kernels.append({
                    "name": name, "route": "cuda", "source": src,
                    "replaces": f"gp_tpu/ops/pallas_kernels.py:{line}",
                    "launches": launches,
                    "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "device_ms": rec["device_ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    # a plain fill of the same output: the card's store
                    # rate, not a library time (it does not compute K)
                    "store_ms": rec["store_ms"],
                    # no single PyTorch call computes a covariance matrix
                    "library_ms": None, "form": form, "p1": rec["p1"],
                    "main_path": kernel,
                    "shape": [rec["m"], rec["n"], rec["d"]],
                    "dtype": "float32"})
        # K3 on every main path; K4 and K5 on the blocked phase, where they
        # are the base_fn of the same factorization.  Times at the leaf's
        # size (b = 128, K5 at w = 32), f32; K4 and K5 also at b = 1024
        chol_src = "gp_tpu_torch/csrc/chol_block.cu"
        chol_rows = [("chol_inv", None, 180, "k3_leaf"),
                     ("cholesky_block", None, 41, "k4_base"),
                     ("cholesky_panel", 32, 87, "k5_base_w32")]
        for name, w, line, variant in chol_rows:
            rec = chol_timed[(name, "float32", LEAF, w)]
            design = rec["design"]
            entry = {"name": name, "route": "cuda", "source": chol_src,
                     "replaces": f"gp_tpu/ops/pallas_chol.py:{line}",
                     "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                     "plain_ms": rec["plain_ms"],
                     "bound_ms": rec["bound_ms"],
                     "bound_by": rec["bound_by"],
                     "library_ms": rec["library_ms"],
                     "library": rec["library"], "w": w,
                     "shape": [LEAF, LEAF], "dtype": "float32",
                     "design": design}
            if name == "chol_inv":
                for kernel, path in paths.items():
                    launches = path["chol_launches"][design]
                    check(launches > 0, f"K3 was not launched on the "
                          f"{kernel} main path")
                    kernels.append({**entry, "launches": launches,
                                    "main_path": kernel})
            else:
                launches = blocked_launches[(variant, "float32")][design]
                check(launches > 0, f"{name} was not launched in the "
                      f"blocked phase")
                big = chol_timed[(name, "float32", K4_BIG, w)]
                entry[f"b{K4_BIG}"] = {
                    k: big[k] for k in ("ms", "library_ms", "bound_ms",
                                        "bound_by", "max_abs_err")}
                kernels.append({**entry, "launches": launches,
                                "main_path": f"blocked ({variant})"})
        # the search and the multi-start run K1 and K3 (times at the main
        # shape, f32, and at b = 128); the sparse paths run K2 in float64
        # (times at (N, M) = (8000, 512), Kuu's (512, 512) beside them)
        def row(name, source, replaces, rec, launches, path, **extra):
            return {"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches,
                    "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    "library_ms": rec.get("library_ms"), "main_path": path,
                    **extra}
        k1 = timed[(kernel_name("se", True), "float32", 1.0)]
        k3 = chol_timed[("chol_inv", "float32", LEAF, None)]
        multi = {"k1": multi["launches"]["se_matrix_diag"]["se"],
                 "k3": multi["chol_launches"]["chol_inv_reg"]}
        for label, path in (("global_search", search["search"]),
                            ("global_search_train_from_inf",
                             search["train_from_inf"]),
                            ("multistart", multi)):
            n1, n3 = path["k1"], path["k3"]
            check(n1 > 0 and n3 > 0, f"K1 or K3 not launched on {label}")
            kernels.append(row(
                "se_tile_diag", src, "gp_tpu/ops/pallas_kernels.py:89", k1,
                n1, label, device_ms=k1["device_ms"], form="se",
                shape=[N_TRAIN, N_TRAIN, DIM], dtype="float32"))
            kernels.append(row(
                "chol_inv", chol_src, "gp_tpu/ops/pallas_chol.py:180", k3,
                n3, label, design="chol_inv_reg", shape=[LEAF, LEAF],
                dtype="float32", library=k3["library"]))
        for model, path in sparse.items():
            n2 = path["launches"]["se_matrix"]["se"]
            check(n2 > 0, f"K2 not launched on sparse_{model.lower()}")
            rec = path["k2"]["kxu"]
            kernels.append(row(
                "se_tile", src, "gp_tpu/ops/pallas_kernels.py:71", rec, n2,
                f"sparse_{model.lower()}", device_ms=rec["device_ms"],
                form="se", shape=[rec["m"], rec["n"], rec["d"]],
                dtype="float64", kuu=path["k2"]["kuu"]))
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
