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

  bucketed_bo  the BO serving path: BucketedGP(X, y, bucket=128) (capacity
             8064) and train(); _update_posterior's time; 64 absorbs of
             held-out rows in O(N^2) (median ms against the bound of three
             reads of the factor's lower triangle, one K2 launch each, the
             factor buffer written in place); their posterior against a
             fresh refactorization at the same hyps, float64 on the card
             within 1e-8, float32 within twice the f32 refactorization's
             gap to f64; one absorb past capacity (capacity 8192, the
             standardization refreshed); add_data within capacity and
             train() (the standardization frozen); predictions and both
             *_with_grad (RMSE below 0.6 of the constant predictor's); K3
             exactly one leaf per 128 padded rows of each blocked
             factorization (64), no K4 or K5; K2 at absorb's (1, N) shape;
             the path's launches (train, the absorbs, the fallback, the
             refit, the predictions) apart from the checks' (the timed
             refactorizations, the f64 twin, the comparison)
  checkpoint save_model of the main path's GP and of bucketed_bo's model,
             load_model onto the card: seconds, bytes, the loaded models'
             predictions bit for bit the saved ones', no launch in the load
  stream_at_golden  the stream regime (N >= 32768) at gp_tpu's N = 51200,
             d = 10 configuration and its golden record's hyps: the f64
             NLL against the record's f64 oracle, the f32 posterior's
             refined NLL, both objective forms (seconds, peak memory,
             gradients against the f64 tiled form), the route; K1 at
             (51200, 51200) x 10 and K2 at its row tiles, in f32 and f64,
             against their plain versions; launches by dtype
  stream_fit GP(X, y).train() from the defaults at N = 51200 of the same
             data (warm start, fit, posterior, refined NLL, the f64 NLL
             beside it: an NLL beyond 1e-4 of it must come with
             set_k_streamed's first-order warning), predictions of 2000
             held-out rows, s2 with its gradient
  bucketed_stream  BucketedGP(X, y, bucket=128) in f32 on the first
             32832 rows of the same data (capacity 32896), where gp_tpu
             runs its dense masked programs: train() from the golden
             record's hyps (the masked NLL), the objective against GP's
             dense form within 1e-6, _update_posterior's time
             and rescue steps, 64 absorbs in O(N^2) against their bound and
             against a fresh refactorization (bucketed_bo's f32 bound),
             one absorb past capacity, the predictions of the 2000 held-out
             rows (RMSE below 0.6 of the constant predictor's); K3 exactly
             one leaf per 128 padded rows of each blocked factorization
  qr_solvers the QR strategies: at N = 8000 f64 the NLL and its gradient
             with chol, qr and qr_pivot (QR against chol), seconds each
             and qr_pivot's factorization alone; the qr_pivot kernel
             (csrc/qr_pivot.cu) against its plain version at N = 2000;
             a qr fit at N = 8000 (f32) and a qr_pivot fit at N = 2000
             (f64): RMSE, f32 against f64, K1/K2/qr_pivot launches and no
             K3; a rank-deficient K whose rescue ends where the CPU's does
  distributed  GP.train_distributed at gp_tpu's dist_fit configuration
             (N = 16384, d = 10) on an NCCL mesh of min(cards, 4)
             processes (parallel.mesh.spawn): fit, seconds and K2 launches
             an evaluation, peak memory, RMSE, the f64 objective and
             posterior against the single card's, save_model ->
             load_model -> restore_distributed bit for bit, and
             FITC.train_distributed at N = 8000, M = 512
  grid       GP.train_distributed on a ("rowg", "colg") grid (parallel/
             pchol2d.py) at gp_tpu's grid_fit configuration (N = 16384,
             d = 10) on grid_shape(min(cards, 4)) NCCL processes ((1, 1)
             on one card): fit, seconds and K2 launches (2) an evaluation
             beside the 1-D phase's and the single card's seconds, peak
             memory, RMSE, the f64 objective and posterior against the
             single card's, save_model -> load_model -> restore_distributed
             and save_model_sharded -> load_model_sharded bit for bit, the
             seconds of each save and load
  cli_gp, cli_fitc  train_x / train_y / test_x written by write_matrix,
             then `python -m gp_tpu_torch gp 8000` and `fitc 8000 512` as
             child processes (CLI_CHILD prints their launch counts): the
             NLL within 1e-5 (gp) and 1e-8 (fitc) of the in-process fits',
             pred within float32 rounding (gp) and 1e-8 (fitc) of theirs

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

import contextlib
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


def _k2_record(torch, se_tile, x1, x2, inv_l, sf2) -> dict:
    """K2 at (x1, x2) in their dtype against its plain version (each entry
    within its rounding bound), times back to back and from a CUDA graph,
    the plain version's and the bound."""
    m, n, d = x1.shape[0], x2.shape[0], x1.shape[1]
    dtype = str(x1.dtype).rsplit(".", 1)[-1]
    kern = lambda: se_tile.se_matrix(inv_l, sf2, x1, x2)
    plain = lambda: se_tile.se_matrix_plain(inv_l, sf2, x1, x2)
    out, ref = kern(), plain()
    bound = se_tile.rounding_bound(inv_l, sf2, x1, x2, ref)
    err = (out - ref).abs()
    # an exact entry is within any bound, 0 included (at a tiny sf2 the
    # bound's sf2 * tiny term underflows to 0)
    ratio = float(torch.where(err == 0, 0.0, err / bound).max())
    check(math.isfinite(ratio) and ratio <= 1.0,
          f"se_tile {dtype} {m}x{n}x{d}: off by {ratio} times its rounding "
          f"bound")
    bound_ms, by = se_bound_ms(m, n, d, dtype, False)
    return {"m": m, "n": n, "d": d, "max_abs_err": float(err.max()),
            "max_err_over_bound": ratio, "ms": cuda_ms(torch, kern),
            "device_ms": graph_ms(torch, kern),
            "plain_ms": cuda_ms(torch, plain, iters=5),
            "bound_ms": bound_ms, "bound_by": by}


# rows of each plain K1 call in _k1_record: the whole plain K at once takes
# ~3 N^2 words of temporaries (63 GB in float64 at N = 51200)
K1_PLAIN_ROWS = 6400


def _k1_record(torch, se_tile, x, inv_l, sf2, dvals) -> dict:
    """K1 at x (n, d) in its dtype: its first and last 64 rows against the
    plain version of those rows (dvals on the diagonal), each entry within
    its rounding bound, as in phase_big_index; times back to back and
    from a CUDA graph; the plain version's over all of K's rows, in calls
    of K1_PLAIN_ROWS rows; the bound."""
    n, d = x.shape
    dtype = str(x.dtype).rsplit(".", 1)[-1]
    kern = lambda: se_tile.se_matrix_diag(inv_l, sf2, x, dvals)
    out = kern()
    torch.cuda.synchronize()
    errs, ratios = [], []
    for rows in (torch.arange(64, device=x.device),
                 torch.arange(n - 64, n, device=x.device)):
        ref = se_tile.se_matrix_plain(inv_l, sf2, x[rows], x)
        ref[torch.arange(64, device=x.device), rows] = dvals[rows]
        bound = se_tile.rounding_bound(inv_l, sf2, x[rows], x, ref)
        err = (out[rows] - ref).abs()
        errs.append(float(err.max()))
        ratios.append(float(torch.where(err == 0, 0.0, err / bound).max()))
    del out
    check(all(math.isfinite(r) and r <= 1.0 for r in ratios),
          f"se_tile_diag {dtype} {n}x{n}x{d}: first/last 64 rows off by "
          f"{ratios} times their rounding bound")

    def plain():
        for j in range(0, n, K1_PLAIN_ROWS):
            b = min(K1_PLAIN_ROWS, n - j)
            K = se_tile.se_matrix_plain(inv_l, sf2, x[j:j + b], x)
            K[:, j:j + b].diagonal().copy_(dvals[j:j + b])
    bound_ms, by = se_bound_ms(n, n, d, dtype, True)
    rec = {"m": n, "n": n, "d": d, "dtype": dtype, "max_abs_err": max(errs),
           "max_err_over_bound": ratios, "ms": cuda_ms(torch, kern, iters=5),
           "device_ms": graph_ms(torch, kern, iters=5),
           "plain_ms": cuda_ms(torch, plain, iters=2, warm=1),
           "plain_rows_per_call": K1_PLAIN_ROWS,
           "bound_ms": bound_ms, "bound_by": by}
    torch.cuda.empty_cache()
    return rec


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
    k2_rec = {"kxu": _k2_record(torch, se_tile, m.train_in, u, inv_l, sf2),
              "kuu": _k2_record(torch, se_tile, u, u, inv_l, sf2)}
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
    return {"launches": launches, "k2": k2_rec, "hyp": m.get_hyp(),
            "nll": nll, "model": m}


N_BUCKET = 128        # capacity 8064 at N = 8000: 64 absorbs fill it
ABSORBS = 64
ADDED = 4             # add_data rows within the grown capacity (8192)


class factorizations:
    """Counts the blocked factorizations inside the block: the outermost
    calls of ops.blocked.blocked_cholesky, which both routes (the
    objective's blocked_factor and set_k's chol.cholesky) look up at call
    time, with the size of each; a factor of n rows pads to the panel
    multiple and runs one K3 leaf per LEAF rows of it."""

    def __enter__(self):
        from gp_tpu_torch.ops import blocked, chol
        self.mod, self.orig, self.sizes = blocked, blocked.blocked_cholesky, []
        depth = [0]

        def wrapped(K, *a, **kw):
            if depth[0] == 0:
                self.sizes.append(K.shape[-1])
            depth[0] += 1
            try:
                return self.orig(K, *a, **kw)
            finally:
                depth[0] -= 1
        blocked.blocked_cholesky = wrapped
        self.block_for = chol._block_for
        return self

    def __exit__(self, *exc):
        self.mod.blocked_cholesky = self.orig

    def leaves(self) -> int:
        return sum(-(-n // self.block_for(n)) * self.block_for(n) // LEAF
                   for n in self.sizes)


def _counts(se_tile, chol_block) -> dict:
    """The launch counts of the SE path's kernels (K1, K2, K3's register
    kernel) and of everything else (other forms, other C entries)."""
    k1 = se_tile.launches["se_matrix_diag"]["se"]
    k2 = se_tile.launches["se_matrix"]["se"]
    k3 = chol_block.launches["chol_inv_reg"]
    total = sum(sum(f.values()) for f in se_tile.launches.values()) \
        + sum(chol_block.launches.values())
    return {"k1": k1, "k2": k2, "k3": k3, "other": total - k1 - k2 - k3}


def _since(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _plus(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def _device_us_by_kernel(prof) -> dict:
    """Device microseconds by kernel name from a torch.profiler run, and
    their sum ("total"); empty when the profiler saw no device time."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0:
            out[e.key[:80]] = us
    if out:
        out["total"] = sum(out.values())
    return out


def _bo_pred(m, Q):
    """(mu, s2) of m at Q in float64."""
    return tuple(t.double() for t in m.batch_predict(Q))


def _rel_gap(a, b, ref) -> list:
    """max |a - b| over max |ref|, for mu and for s2."""
    return [float((x - y).abs().max() / r.abs().max())
            for x, y, r in zip(a, b, ref)]


def phase_bucketed_bo(torch, Xtr, ytr, Xte, yte) -> dict:
    """The Bayesian-optimisation serving path on the card (SE-ARD f32):
    BucketedGP(X, y, bucket=128) at N = 8000 (capacity 8064) and train();
    _update_posterior's time; 64 absorbs of held-out rows (8001-8064), each
    on the O(N^2) branch (the factor buffer written in place, one K2 and no
    K1 or K3 launch each): the median ms against the bound of three reads
    of the factor's lower triangle; then their posterior against a fresh
    refactorization at the same hyps, in float64 on the card within 1e-8
    and in float32 within twice the f32 refactorization's own gap to f64
    (the two f32 posteriors are then no further apart than the sum of
    their gaps to f64, if the appended one is no less accurate than the
    refactorization); one absorb past capacity (the fallback: capacity
    8192, the standardization refreshed); add_data of ADDED rows within
    capacity and train() (the standardization frozen); the predictions on
    the rest of the held-out rows (RMSE below 0.6 of the constant
    predictor's).  K3 runs exactly one leaf per 128 padded rows of each
    blocked factorization (64 at these sizes), and no K4 or K5.  The
    path's launches ("launches", the kernels line's) sum train, the 64
    absorbs, the fallback, add_data's train and the predictions: not the
    timed refactorizations, nor the f64 twin and the refactorizations of
    the comparison ("check_launches")."""
    import numpy as np
    from gp_tpu_torch import BucketedGP
    from gp_tpu_torch.ops import chol_block, se_tile
    from gp_tpu_torch.optim.lbfgsb import explain_result

    se_tile.reset_launches()
    chol_block.reset_launches()
    phase_t0 = time.perf_counter()
    with factorizations() as fz:
        t0 = time.perf_counter()
        bo = BucketedGP(Xtr, ytr, bucket=N_BUCKET)
        check(bo.device.type == "cuda" and bo.dtype == torch.float32
              and bo.capacity == N_TRAIN + ABSORBS, "BucketedGP(X, y, "
              "bucket=128) must default to CUDA float32 at capacity 8064")
        nll = bo.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    train_counts = _counts(se_tile, chol_block)
    evals = int(bo.last_opt_result.evals)
    status = explain_result(bo.last_opt_result)
    check(train_counts["k1"] >= evals, f"bucketed train: K1 launched "
          f"{train_counts['k1']} times for {evals} evaluations")
    check(train_counts["k3"] == fz.leaves() == LEAVES_PER_FACTOR
          * len(fz.sizes) and train_counts["other"] == 0,
          f"bucketed train: {train_counts} for {len(fz.sizes)} blocked "
          f"factorizations of sizes {sorted(set(fz.sizes))}")
    hyp = bo.get_hyp()
    path = dict(train_counts)

    # one refactorization at the fitted hyps: the fallback's cost
    before = _counts(se_tile, chol_block)
    with factorizations() as fz:
        upd_ms = cuda_ms(torch, bo._update_posterior, iters=3, warm=1)
    upd = _since(before, _counts(se_tile, chol_block))
    check(np.array_equal(bo.get_hyp(), hyp), "_update_posterior at the "
          "fitted hyps inflated the noise")
    check(upd["k3"] == LEAVES_PER_FACTOR * len(fz.sizes) == LEAVES_PER_FACTOR
          * 4 and upd["k1"] == 0 and upd["other"] == 0,
          f"_update_posterior: {upd} for {len(fz.sizes)} factorizations")

    # 64 absorbs: 8000 -> 8064 = capacity, each appended in O(N^2)
    L0 = bo._post[0]
    before = _counts(se_tile, chol_block)
    span_ms, wall_ms = [], []
    for i in range(ABSORBS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # the first absorb runs under torch.profiler: its device time by
        # kernel (the profiler's host cost lands in this one sample)
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if i == 0 \
            else contextlib.nullcontext()
        with prof:
            t0 = time.perf_counter()
            start.record()
            bo.absorb(Xte[i], yte[i])
            end.record()
            end.synchronize()
        if i == 0:
            absorb_profile = _device_us_by_kernel(prof)
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        span_ms.append(start.elapsed_time(end))
        check(bo._post[0] is L0, f"absorb {i}: the factor was not appended "
              f"in place")
    absorbs = _since(before, _counts(se_tile, chol_block))
    cap = bo.capacity
    check(bo.num_train == cap == N_TRAIN + ABSORBS and bo.trained,
          f"after {ABSORBS} absorbs: {bo.num_train} rows, capacity {cap}")
    check(absorbs == {"k1": 0, "k2": ABSORBS, "k3": 0, "other": 0},
          f"{ABSORBS} absorbs launched {absorbs}: one K2 each expected")
    absorb_bound = 3 * cap * cap / 2 * 4 / PEAK_BYTES_S * 1e3
    path = _plus(path, absorbs)

    # the appended posterior against a fresh one at the same hyps, f64 and
    # f32, on the held-out rows the phase never adds
    Q = Xte[ABSORBS + 1 + ADDED:]
    before = _counts(se_tile, chol_block)
    b64 = BucketedGP(Xtr, ytr, bucket=N_BUCKET, dtype=torch.float64)
    b64._hyps = b64._tensor(hyp)
    b64._update_posterior()
    b64._trained = True
    for i in range(ABSORBS):
        b64.absorb(Xte[i], yte[i])
    app32, app64 = _bo_pred(bo, Q), _bo_pred(b64, Q)
    bo._update_posterior()
    b64._update_posterior()
    check(np.array_equal(bo.get_hyp(), hyp)
          and np.array_equal(b64.get_hyp(), hyp),
          "the refactorization at the fitted hyps inflated the noise")
    ref32, ref64 = _bo_pred(bo, Q), _bo_pred(b64, Q)
    del b64
    compare = _since(before, _counts(se_tile, chol_block))
    gap64 = _rel_gap(app64, ref64, ref64)
    gap32 = _rel_gap(app32, ref32, ref64)
    ref_gap32 = _rel_gap(ref32, ref64, ref64)
    bound32 = [2 * g for g in ref_gap32]

    # one absorb past capacity: add_data (the buffers grow, the
    # standardization refreshes) and a refactorization
    mu0 = bo._y_mu
    before = _counts(se_tile, chol_block)
    with factorizations() as fz:
        t0 = time.perf_counter()
        bo.absorb(Xte[ABSORBS], yte[ABSORBS])
        torch.cuda.synchronize()
        fallback_s = time.perf_counter() - t0
    fallback = _since(before, _counts(se_tile, chol_block))
    path = _plus(path, fallback)
    # the model's targets, in its dtype, as its standardization reads them
    y_all = bo._y.double().cpu().numpy()
    check(np.array_equal(y_all, np.concatenate([ytr, yte[:ABSORBS + 1]])
                         .astype(np.float32)), "absorb dropped or moved a "
          "target")
    cap = N_TRAIN + ABSORBS + N_BUCKET
    check(bo.capacity == cap and bo.num_train == N_TRAIN + ABSORBS + 1
          and bo.trained and tuple(bo._post[0].shape) == (cap, cap),
          f"absorb past capacity: capacity {bo.capacity}, "
          f"{bo.num_train} rows")
    check(bo._y_mu != mu0 and bo._y_mu == float(np.mean(y_all))
          and bo._y_sigma == float(np.std(y_all, ddof=1)),
          "absorb past capacity did not refresh the standardization")
    check(fallback["k3"] == fz.leaves() == LEAVES_PER_FACTOR
          and fallback["k1"] == 0 and fallback["other"] == 0,
          f"absorb past capacity launched {fallback} for factorizations of "
          f"{fz.sizes}")

    # add_data within capacity, then train() from the current hyps
    frozen = (bo._y_mu, bo._y_sigma)
    lo = ABSORBS + 1
    before = _counts(se_tile, chol_block)
    bo.add_data(Xte[lo:lo + ADDED], yte[lo:lo + ADDED])
    check(bo.capacity == cap and (bo._y_mu, bo._y_sigma) == frozen,
          "add_data within capacity moved the capacity or the "
          "standardization")
    with factorizations() as fz:
        t0 = time.perf_counter()
        nll2 = bo.train(bo.get_hyp())
        torch.cuda.synchronize()
        train2_s = time.perf_counter() - t0
    train2 = _since(before, _counts(se_tile, chol_block))
    check((bo._y_mu, bo._y_sigma) == frozen and math.isfinite(nll2),
          "train() after add_data moved the standardization or ended INF")
    check(train2["k3"] == fz.leaves() == LEAVES_PER_FACTOR * len(fz.sizes)
          and train2["other"] == 0, f"train() after add_data: {train2} "
          f"for {len(fz.sizes)} blocked factorizations")

    # the BO acquisition's queries on the remaining held-out rows
    mu, s2 = bo.batch_predict(Q)
    yg, gy = bo.batch_predict_y_with_grad(Q[:N_GRAD])
    sg, gs = bo.batch_predict_s2_with_grad(Q[:N_GRAD])
    torch.cuda.synchronize()
    for k, v in {"mu": mu, "s2": s2, "y_wg": yg, "gy": gy, "s2_wg": sg,
                 "gs2": gs}.items():
        check(bool(torch.isfinite(v).all()), f"bucketed {k} not finite")
    rmse = _rmse(mu.cpu().numpy(), yte[ABSORBS + 1 + ADDED:])
    rmse_const = _rmse(np.full(len(Q), ytr.mean()),
                       yte[ABSORBS + 1 + ADDED:])
    path = _plus(path, _since(before, _counts(se_tile, chol_block)))
    res = {"n": N_TRAIN, "bucket": N_BUCKET,
           "capacity_after_train": N_TRAIN + ABSORBS,
           "nll": nll, "evals": evals, "train_s": train_s,
           "status": status, "update_posterior_ms": upd_ms,
           "absorb_ms_median": float(np.median(span_ms)),
           "absorb_ms_max": float(np.max(span_ms)),
           "absorb_host_ms_median": float(np.median(wall_ms)),
           "absorb_bound_ms": absorb_bound, "absorb_bound_by": "bytes",
           "absorb_launches": absorbs,
           "absorb_profile_device_us": absorb_profile,
           "appended_vs_refactorized": {
               "f64_rel_gap_mu_s2": gap64, "f64_limit": 1e-8,
               "f32_rel_gap_mu_s2": gap32, "f32_bound_mu_s2": bound32,
               "f32_refactorization_gap_to_f64_mu_s2": ref_gap32},
           "fallback_s": fallback_s, "fallback_launches": fallback,
           "capacity_after_fallback": bo.capacity,
           "y_mu": bo._y_mu, "y_sigma": bo._y_sigma,
           "train_after_add_data": {"nll": nll2, "seconds": train2_s,
                                    "evals": int(bo.last_opt_result.evals)},
           "rmse": rmse, "rmse_const": rmse_const,
           "train_launches": train_counts, "launches": path,
           "check_launches": {"update_posterior_timed": upd,
                              "f64_twin_and_refactorizations": compare},
           "seconds": time.perf_counter() - phase_t0}
    emit("bucketed_bo", **res)
    check(max(gap64) <= 1e-8, f"f64: absorbed posterior {gap64} from the "
          f"refactorization's, beyond 1e-8")
    check(gap32[0] <= bound32[0] and gap32[1] <= bound32[1],
          f"f32: absorbed posterior {gap32} from the refactorization's, "
          f"beyond {bound32}")
    check(rmse < 0.6 * rmse_const, f"bucketed: held-out RMSE {rmse} not "
          f"below 0.6 of the constant predictor's {rmse_const}")
    x1 = bo._tensor(Xte[:1])
    chyp = bo._hyps[:DIM + 1]
    k2 = _k2_record(torch, se_tile, x1, bo._x, torch.exp(-chyp[:DIM]),
                    torch.exp(2.0 * chyp[DIM]))
    return {"model": bo, "launches": path, "k2_absorb": k2}


def phase_checkpoint(torch, models: dict, Xte) -> None:
    """save_model of trained models (the main path's GP, bucketed_bo's
    BucketedGP) and load_model onto the card: seconds and bytes; the
    loaded model's predictions bit for bit the saved one's, and no launch
    at all in the load (no refactorization)."""
    import tempfile
    from gp_tpu_torch.ops import chol_block, se_tile
    from gp_tpu_torch.utils.checkpoint import load_model, save_model

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, m in models.items():
            path = os.path.join(tmp, f"{label}.npz")
            t0 = time.perf_counter()
            save_model(m, path)
            save_s = time.perf_counter() - t0
            se_tile.reset_launches()
            chol_block.reset_launches()
            t0 = time.perf_counter()
            r = load_model(path)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            loaded = _counts(se_tile, chol_block)
            check(type(r) is type(m) and r.device.type == "cuda"
                  and r.dtype == m.dtype and r.trained,
                  f"checkpoint {label}: loaded {type(r).__name__} on "
                  f"{r.device}, {r.dtype}")
            check(not any(loaded.values()), f"checkpoint {label}: the load "
                  f"launched {loaded}")
            same = all(torch.equal(a, b) for a, b in
                       zip((*m.batch_predict(Xte), m.batch_predict_y(Xte)),
                           (*r.batch_predict(Xte), r.batch_predict_y(Xte))))
            res[label] = {"model": type(m).__name__, "n": m.num_train,
                          "save_s": save_s, "bytes": os.path.getsize(path),
                          "load_s": load_s, "load_launches": loaded,
                          "predictions_bit_equal": same}
            check(same, f"checkpoint {label}: the loaded model's predictions "
                  f"differ from the saved one's")
            del r
    emit("checkpoint", **res)


# `python -m gp_tpu_torch` as a child process that also prints the launch
# counts of its run (on its last line): runpy runs the package's
# __main__ as -m does
CLI_CHILD = """\
import json, runpy, sys
from gp_tpu_torch.ops import chol_block, se_tile
sys.argv = ["gp_tpu_torch", *sys.argv[1:]]
try:
    runpy.run_module("gp_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as exc:
    code = exc.code
print(json.dumps({"se_tile": se_tile.launches,
                  "chol_block": chol_block.launches}))
sys.exit(code)
"""


def phase_cli(torch, Xtr, ytr, Xte, gp, fitc) -> dict:
    """train_x / train_y / test_x written with write_matrix (17 digits:
    float64 round-trips exactly) into a temporary directory, then
    `python -m gp_tpu_torch gp 8000` and `fitc 8000 512` there as child
    processes, on the card: seconds, the NLL from their stdout, pred.  The
    gp NLL within 1e-5 of main_path's and pred within float32 rounding
    (4 ulp of the largest value) of the in-process model's; FITC's NLL and
    pred within 1e-8 of sparse_fitc's."""
    import tempfile
    import numpy as np
    from gp_tpu_torch.utils.io import read_matrix, write_matrix

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for name, a in (("train_x", Xtr), ("train_y", ytr), ("test_x", Xte)):
            write_matrix(os.path.join(tmp, name), a)
        write_s = time.perf_counter() - t0
        check(np.array_equal(read_matrix(os.path.join(tmp, "train_x")), Xtr)
              and np.array_equal(read_matrix(os.path.join(tmp, "train_y"))
                                 .ravel(), ytr),
              "the text files do not round-trip float64")
        pp = os.environ.get("PYTHONPATH")
        env = dict(os.environ, PYTHONPATH=ROOT + (os.pathsep + pp if pp
                                                  else ""))
        runs = (("cli_gp", ["gp", str(N_TRAIN)], gp, 1e-5),
                ("cli_fitc", ["fitc", str(N_TRAIN), str(N_INDUCING)], fitc,
                 1e-8))
        for phase, args, model, tol in runs:
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-c", CLI_CHILD, *args],
                               cwd=tmp, env=env, capture_output=True,
                               text=True, timeout=600)
            secs = time.perf_counter() - t0
            check(r.returncode == 0, f"{phase}: exit {r.returncode}: "
                  f"{r.stderr[-2000:]}")
            lines = r.stdout.strip().splitlines()
            launches = json.loads(lines[-1])
            nll = float(re.search(r"Negative log likelihood: (\S+)",
                                  r.stdout).group(1))
            pred = read_matrix(os.path.join(tmp, "pred"))
            mu = model.batch_predict_y(Xte).cpu().numpy()
            sd = np.sqrt(model.batch_predict_s2(Xte).cpu().numpy())
            ref_nll = model.nll()
            nll_rel = abs(nll - ref_nll) / abs(ref_nll)
            gaps = [float(np.max(np.abs(pred[:, k] - v)) / np.max(np.abs(v)))
                    for k, v in enumerate((mu, sd))]
            pred_tol = 4 * 2.0 ** -23 if model.dtype == torch.float32 \
                else 1e-8
            res = {"args": args, "seconds": secs, "write_s": write_s,
                   "nll": nll, "in_process_nll": ref_nll,
                   "nll_rel_gap": nll_rel, "nll_tol": tol,
                   "pred_rel_gap_mu_sd": gaps, "pred_tol": pred_tol,
                   "pred_shape": list(pred.shape),
                   "status_line": lines[1] if len(lines) > 1 else "",
                   "launches": launches}
            emit(phase, **res)
            check(pred.shape == (N_TEST, 2) and np.isfinite(pred).all(),
                  f"{phase}: pred of shape {pred.shape} or not finite")
            check(nll_rel <= tol, f"{phase}: NLL {nll} against the in-process "
                  f"{ref_nll}, beyond {tol}")
            check(max(gaps) <= pred_tol, f"{phase}: pred {gaps} from the "
                  f"in-process model's, beyond {pred_tol}")
            out[phase] = launches
    return out


# The stream regime (models/exact.py, N >= 32768): gp_tpu's N = 51200,
# d = 10 configuration (benchmarks/big_fit.py fit50k: make_data(51200,
# d=10, seed=42), held out make_data(2000, 10, seed=7)) and its golden
# record (never edited)
STREAM_N, STREAM_D = 51200, 10
STREAM_TEST_N, STREAM_TEST_SEED = 2000, 7
STREAM_GRAD = 16
GOLDEN_STREAM = "benchmarks/golden/tpu_fit_n51200_warm.json"
# the golden record's parity targets: an independent NumPy/SciPy float64
# evaluation at the recorded hyps (the oracle), gp_tpu's refined f32 NLL
# against it, and the f32 objective's gradient against float64's
ORACLE_F64_TOL, REFINED_F32_TOL, GRAD_F32_TOL = 1e-8, 1e-4, 1e-2
# the two variance paths at the same rows: 8 float32 ulps of the prior
S2_TOL = 8 * 2.0 ** -23


def _leaves(n: int) -> int:
    """K3 leaves of one blocked factorization at n rows."""
    from gp_tpu_torch.ops.chol import _block_for
    blk = _block_for(n)
    return -(-n // blk) * blk // LEAF


class tee_stderr:
    """Copies what is written to stderr inside it into `text`, and still
    writes it."""

    def __enter__(self):
        import io
        self.buf, self.orig = io.StringIO(), sys.stderr
        orig, buf = self.orig, self.buf

        class Tee:
            def write(self, s):
                buf.write(s)
                return orig.write(s)

            def flush(self):
                orig.flush()
        sys.stderr = Tee()
        return self

    def __exit__(self, *exc):
        sys.stderr = self.orig
        self.text = self.buf.getvalue()


def _rescue_steps(text: str) -> int:
    """The rescue attempts set_k_streamed reported on stderr (0: none)."""
    m = re.search(r"set_k_streamed: noise raised .*?\((\d+) rescue", text)
    return int(m.group(1)) if m else 0


def _left_out(text: str):
    """What set_k_streamed's first-order warning on stderr says the refined
    NLL leaves out, tr(E^2) / 4 (None: no warning)."""
    m = re.search(r"set_k_streamed: the refined NLL \S+ may be off by "
                  r"~(\S+) ", text)
    return float(m.group(1)) if m else None


def _stream_eval(torch, fn, gp, hyp) -> dict:
    """One objective evaluation fn(kernel, hyp_std, x, ys) of `gp` at the
    original-units hyp: value, gradient (float64, on the host), synced
    seconds and the bytes it added at its peak, also in words of N^2."""
    h = gp._tensor(gp._hyp_to_std(hyp))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    f, g = fn(gp.kernel, h, gp._x, gp._ys)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    n, size = gp.num_train, torch.finfo(gp.dtype).bits // 8
    return {"f": float(f), "g": g.double().cpu(), "s": secs,
            "peak_gb": peak / 1e9, "words_n2": peak / (n * n * size)}


def phase_stream_at_golden(torch) -> dict:
    """The stream regime at gp_tpu's golden N = 51200 record's hyps: the
    float64 nll_raw against the oracle (ORACLE_F64_TOL); the float32
    set_k_streamed (the posterior), its refined NLL against the oracle
    (REFINED_F32_TOL), its rescue steps and the raw f32 NLL beside it; one
    f32 objective evaluation in each form (nll_vg_raw, dense, and
    nll_vg_streamed, tiled), twice: seconds, peak memory, value and
    gradient against each other; the tiled form in float64 as the oracle
    of the f32 gradients (GRAD_F32_TOL of its largest entry); the form
    objective_vg picks in each dtype; the dense form's measured words of
    N^2 within the route's estimate (exact._DENSE_VG_WORDS); K1 at the
    model's build and K2 at the row tiles' shape, in each dtype, against
    their plain versions (_k1_record, _k2_record).  Every K1 build is
    factored once (400 K3 leaves, all by the register kernel); launches
    are counted by dtype.  Also reported: what set_k_streamed's
    first-order warning says the refined NLL leaves out (None: no
    warning)."""
    import numpy as np
    from gp_tpu_torch import GP
    from gp_tpu_torch.models import exact
    from gp_tpu_torch.models.sparse import hbm_budget_bytes
    from gp_tpu_torch.ops import chol_block, se_tile
    from gp_tpu_torch.utils.synth import make_data

    with open(os.path.join(ROOT, GOLDEN_STREAM)) as fh:
        golden = json.load(fh)
    oracle = golden["oracle_f64_nll"]
    hyp = np.asarray(golden["hyp"], np.float64)
    X, y = make_data(STREAM_N, d=STREAM_D, seed=SEED)
    torch.cuda.empty_cache()
    se_tile.reset_launches()
    chol_block.reset_launches()
    res = {"n": STREAM_N, "d": STREAM_D, "oracle_f64_nll": oracle,
           "golden_log_sn": float(hyp[-2]),
           "budget_gb": hbm_budget_bytes(torch.device("cuda")) / 1e9}

    gp64 = GP(X, y, dtype="float64")
    t0 = time.perf_counter()
    nll64 = gp64.nll(hyp)
    res["nll_f64_s"] = time.perf_counter() - t0
    launches64 = _counts(se_tile, chol_block)
    res["nll_f64"] = nll64
    res["nll_f64_rel"] = abs(nll64 - oracle) / abs(oracle)

    gp32 = GP(X, y)
    t0 = time.perf_counter()
    with tee_stderr() as err:
        h, aux, invkys = exact.set_k_streamed(gp32.kernel, gp32._tensor(hyp),
                                              gp32._x, gp32._y)
        torch.cuda.synchronize()
    res["set_k_streamed_s"] = time.perf_counter() - t0
    res["rescue_steps"] = _rescue_steps(err.text)
    res["posterior_log_sn"] = float(h[-2])
    res["refined_nll_f32"] = aux["nll_refined"]
    res["refined_rel"] = abs(aux["nll_refined"] - oracle) / abs(oracle)
    res["first_order_left_out"] = _left_out(err.text)
    res["raw_nll_f32"] = gp32.nll(hyp)
    res["raw_rel"] = abs(res["raw_nll_f32"] - oracle) / abs(oracle)
    del invkys

    forms = {"dense_f32": (gp32, exact.nll_vg_raw),
             "tiled_f32": (gp32, exact.nll_vg_streamed),
             "tiled_f64": (gp64, exact.nll_vg_streamed)}
    evals = {}
    for label, (gp, fn) in forms.items():
        before = _counts(se_tile, chol_block)
        runs = [_stream_eval(torch, fn, gp, hyp)
                for _ in range(1 if label == "tiled_f64" else 2)]
        if gp is gp64:
            launches64 = _plus(launches64, _since(
                before, _counts(se_tile, chol_block)))
        evals[label] = runs[-1]
        res[label] = {"s_per_eval": [r["s"] for r in runs],
                      "peak_gb": runs[-1]["peak_gb"],
                      "words_n2": runs[-1]["words_n2"],
                      "value": runs[-1]["f"]}
    g64 = evals["tiled_f64"]["g"]
    scale = float(g64.abs().max())
    for label in ("dense_f32", "tiled_f32"):
        e = evals[label]
        res[label]["grad_gap_vs_f64"] = float((e["g"] - g64).abs().max()) \
            / scale
        res[label]["value_gap_vs_f64"] = abs(e["f"] - evals["tiled_f64"]
                                             ["f"]) / abs(evals["tiled_f64"]
                                                          ["f"])
    res["dense_vs_tiled_f32"] = {
        "value_rel": abs(evals["dense_f32"]["f"] - evals["tiled_f32"]["f"])
        / abs(evals["tiled_f32"]["f"]),
        "grad_over_f64_max": float((evals["dense_f32"]["g"]
                                    - evals["tiled_f32"]["g"]).abs().max())
        / scale}
    res["route"] = {dt: "tiled" if exact.use_streamed_vg(gp.kernel, gp._x)
                    else "dense" for dt, gp in (("float32", gp32),
                                                ("float64", gp64))}
    res["route_words_estimate"] = exact._DENSE_VG_WORDS
    total = _counts(se_tile, chol_block)
    launches = {"float32": _since(launches64, total), "float64": launches64}
    res["launches"] = launches
    # K1 at the model's build, K2 at the refinement sweep's and the tiled
    # gradient's row tiles, in each dtype
    res["k1"], res["k2_tile"] = {}, {}
    for dt, gp in (("float32", gp32), ("float64", gp64)):
        x, h = gp._x, gp._tensor(hyp)
        inv_l = torch.exp(-h[:STREAM_D])
        sf2 = torch.exp(2.0 * h[STREAM_D])
        dvals = torch.full((STREAM_N,), float(sf2 + torch.exp(2.0 * h[-2])),
                           dtype=x.dtype, device=x.device)
        res["k1"][dt] = _k1_record(torch, se_tile, x, inv_l, sf2, dvals)
        res["k2_tile"][dt] = _k2_record(torch, se_tile, x[:2048], x, inv_l,
                                        sf2)
    emit("stream_at_golden", **res)

    check(res["nll_f64_rel"] <= ORACLE_F64_TOL,
          f"f64 NLL {nll64} against the oracle {oracle}: "
          f"{res['nll_f64_rel']} beyond {ORACLE_F64_TOL}")
    check(res["refined_rel"] <= REFINED_F32_TOL,
          f"f32 refined NLL {aux['nll_refined']} against the oracle "
          f"{oracle}: {res['refined_rel']} beyond {REFINED_F32_TOL}")
    for label in ("dense_f32", "tiled_f32"):
        gap = res[label]["grad_gap_vs_f64"]
        check(math.isfinite(gap) and gap <= GRAD_F32_TOL,
              f"{label} gradient {gap} of the f64 gradient's largest entry "
              f"from it, beyond {GRAD_F32_TOL}")
    check(res["route"] == {"float32": "dense", "float64": "tiled"},
          f"objective_vg's route at N = {STREAM_N}: {res['route']}")
    est = exact._DENSE_VG_WORDS["se"]
    check(res["dense_f32"]["words_n2"] <= est,
          f"the dense objective took {res['dense_f32']['words_n2']} words "
          f"of N^2, beyond the route's estimate {est}")
    for dt, n in launches.items():
        check(n["k1"] > 0 and n["k2"] > 0
              and n["k3"] == _leaves(STREAM_N) * n["k1"] and n["other"] == 0,
              f"stream_at_golden {dt}: every K1 build factored once by "
              f"{_leaves(STREAM_N)} register leaves, K2 in the sweeps: {n}")
    del gp64, gp32
    torch.cuda.empty_cache()
    return {"launches": launches, "k1": res["k1"], "k2": res["k2_tile"]}


def phase_stream_fit(torch) -> dict:
    """GP(X, y).train() in the stream regime from the defaults, float32,
    at STREAM_N rows of the stream configuration's data: the subset-
    MLE warm start (m = 8192), the fit, the posterior (set_k_streamed:
    the rescue steps, the refined NLL that train() returns); then
    batch_predict of the 2000 held-out rows (it refactors: RMSE below 0.6
    of the constant predictor's) and batch_predict_s2_with_grad of 16 of
    them (finite).  The launch counts are set to 0 just before the model
    is built and read after those predictions.  Then the checks, their
    launches counted apart: batch_predict of the same 16 rows, whose s2
    must equal batch_predict_s2_with_grad's within S2_TOL of the prior
    variance sf2 + sn2 (the same factor, K2 rows and solve; across batch
    sizes the solve's f32 rounding moves s2 by ~1e-4 of it), and the f64
    NLL at the fitted hyps beside the refined one: beyond
    REFINED_F32_TOL of it, set_k_streamed must have warned that its
    refined NLL is first order.  Also reported:
    whether the fit entered the global search, and c = sn2 / (N eps
    mean(sf2)), where the fitted noise sits against the f32 conditioning
    floor."""
    import numpy as np
    from gp_tpu_torch import GP
    from gp_tpu_torch.ops import chol_block, se_tile
    from gp_tpu_torch.optim.lbfgsb import explain_result
    from gp_tpu_torch.utils.synth import make_data

    X, y = make_data(STREAM_N, d=STREAM_D, seed=SEED)
    Xte, yte = make_data(STREAM_TEST_N, d=STREAM_D, seed=STREAM_TEST_SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    se_tile.reset_launches()
    chol_block.reset_launches()
    gp = GP(X, y)
    check(gp._in_stream_regime(), f"GP at N = {STREAM_N} is not in "
          f"the stream regime")
    secs = {}

    def timed(name):
        fn = getattr(gp, name)

        def run(*a):
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t
            return out
        setattr(gp, name, run)
    for name in ("_warm_start_hyps", "_run_local_opt", "_update_posterior"):
        timed(name)
    t0 = time.perf_counter()
    with tee_stderr() as err:
        nll = gp.train()
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches_train = _counts(se_tile, chol_block)
    evals = int(gp.last_opt_result.evals)
    t0 = time.perf_counter()
    mu, s2 = gp.batch_predict(Xte)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s2g, gs2 = gp.batch_predict_s2_with_grad(Xte[:STREAM_GRAD])
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    launches = _counts(se_tile, chol_block)

    _, s2_16 = gp.batch_predict(Xte[:STREAM_GRAD])
    hyp = gp.get_hyp()
    prior = float(np.exp(2 * hyp[STREAM_D]) + np.exp(2 * hyp[-2]))
    s2_gap = float((s2g - s2_16).abs().max()) / prior
    s2_gap_2000 = float((s2g - s2[:STREAM_GRAD]).abs().max()) / prior
    nll64 = GP(X, y, dtype="float64").nll(hyp)
    check_launches = _since(launches, _counts(se_tile, chol_block))
    rmse = _rmse(mu.cpu().numpy(), yte)
    rmse_const = _rmse(np.full_like(yte, y.mean()), yte)
    eps32 = float(torch.finfo(torch.float32).eps)
    res = {"n": STREAM_N, "d": STREAM_D, "nll": nll,
           "nll_is_refined": nll == gp._post_aux["nll_refined"],
           "nll_f64_at_fit": nll64,
           "refined_rel_to_f64": abs(nll - nll64) / abs(nll64),
           "evals": evals, "status": explain_result(gp.last_opt_result),
           "entered_search": gp.last_search is not None,
           "warm_start_s": secs.get("_warm_start_hyps"),
           "fit_s": secs["_run_local_opt"],
           "s_per_eval": secs["_run_local_opt"] / evals,
           "posterior_s": secs["_update_posterior"], "train_s": train_s,
           "rescue_steps": _rescue_steps(err.text),
           "first_order_left_out": _left_out(err.text),
           "c_floor": float(np.exp(2 * hyp[-2]) / (
               STREAM_N * eps32 * np.exp(2 * hyp[STREAM_D]))),
           "hyp": hyp.tolist(),
           "predict_2000_s": predict_s, "s2_with_grad_16_s": grad_s,
           "rmse": rmse, "rmse_const": rmse_const,
           "s2_gap_over_prior": s2_gap,
           "s2_gap_over_prior_vs_2000_rows": s2_gap_2000,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_train": launches_train, "launches": launches,
           "check_launches": check_launches}
    emit("stream_fit", **res)
    check(math.isfinite(nll) and res["nll_is_refined"],
          f"train() returned {nll}, not the posterior's refined NLL")
    check(res["refined_rel_to_f64"] <= REFINED_F32_TOL
          or res["first_order_left_out"] is not None,
          f"train()'s refined NLL {nll} is {res['refined_rel_to_f64']} from "
          f"the f64 NLL {nll64}, beyond {REFINED_F32_TOL}, and "
          f"set_k_streamed did not warn that it is first order")
    check(bool(torch.isfinite(mu).all() and torch.isfinite(s2).all()
               and torch.isfinite(s2g).all() and torch.isfinite(gs2).all()),
          "stream_fit: non-finite predictions")
    check(tuple(gs2.shape) == (STREAM_GRAD, STREAM_D), "gradient shape")
    check(rmse < 0.6 * rmse_const, f"stream_fit: held-out RMSE {rmse} not "
          f"below 0.6 of the constant predictor's {rmse_const}")
    check(s2_gap <= S2_TOL, f"batch_predict_s2_with_grad's s2 {s2_gap} of "
          f"the prior variance from batch_predict's, beyond {S2_TOL}")
    check(launches_train["k1"] >= evals and launches["k2"] > 0
          and launches["k3"] >= _leaves(STREAM_N) * evals
          and launches["other"] == 0,
          f"stream_fit: K1 a build per evaluation, K2, K3 by its register "
          f"kernel only: {launches} for {evals} evaluations")
    del gp
    torch.cuda.empty_cache()
    return {"launches": launches}


# BucketedGP at the stream configuration: the first multiple of 64 from
# _STREAM_MIN_N whose capacity (bucket 128: 32896) leaves ABSORBS rows of
# room
BS_N = 32832
LOG_SQRT10 = 0.5 * math.log(10.0)


def phase_bucketed_stream(torch) -> dict:
    """BucketedGP(X, y, bucket=128) in float32 on the first BS_N = 32832
    rows of the stream configuration's data (capacity 32896), where gp_tpu
    runs its dense masked programs: train() from the golden record's hyps
    (GOLDEN_STREAM), as a BO loop refits from its last hyperparameters
    (from the defaults the fit took 101 evaluations, 131 s on an H100,
    and the script's time limit has no room for them; the subset-MLE
    warm start that a default start probes is held against gp_tpu's on
    the CPU, tests/test_torch_bucketed_stream.py): evaluations, seconds per
    evaluation, the masked NLL, no refined NLL, peak memory; the
    objective at the fitted hyps against GP's dense form on the same rows
    (exact.objective_vg, both alpha by the factor on the blocked route:
    value within 1e-6); _update_posterior's time and the rescue steps of
    train()'s posterior (set_k_masked's sqrt(10) ladder); 64 absorbs of the
    rows after BS_N, each on the O(N^2) branch (the factor written in
    place, one K2 launch each; median ms against the bound of three reads
    of the factor's lower triangle), their posterior against a fresh
    refactorization at the same hyps within twice the f32
    refactorization's own gap to an f64 refactorization (bucketed_bo's
    bound), the f64 twin also absorbed, and each f32 mean's gap to f64's
    (absorb's chol_solve, gp_tpu's two triangular solves on the same
    factor, the refactorization's); one absorb past capacity (the
    fallback: capacity 33024, the standardization refreshed); then
    batch_predict, batch_predict_y and both *_with_grad of the 2000
    held-out rows (RMSE below 0.6 of the constant predictor's).  The
    counts are set to 0 just before the model is built; the path's
    launches (train, the absorbs, the fallback, the predictions) must show
    K1 a build per evaluation, K3 exactly one register leaf per 128 padded
    rows of each blocked factorization (_leaves), no K4 or K5; the checks'
    launches are counted apart."""
    import numpy as np
    from gp_tpu_torch import BucketedGP
    from gp_tpu_torch.models import exact
    from gp_tpu_torch.models.base import hyp_mean, to_opt_vec
    from gp_tpu_torch.ops import chol_block, se_tile
    from gp_tpu_torch.ops.chol import solve_lower, solve_lower_t
    from gp_tpu_torch.optim.lbfgsb import explain_result
    from gp_tpu_torch.utils.synth import make_data

    X, y = make_data(STREAM_N, d=STREAM_D, seed=SEED)
    Xte, yte = make_data(STREAM_TEST_N, d=STREAM_D, seed=STREAM_TEST_SEED)
    Xtr, ytr = X[:BS_N], y[:BS_N]
    with open(os.path.join(ROOT, GOLDEN_STREAM)) as fh:
        start = np.asarray(json.load(fh)["hyp"], np.float64)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    se_tile.reset_launches()
    chol_block.reset_launches()
    phase_t0 = time.perf_counter()
    bo = BucketedGP(Xtr, ytr, bucket=N_BUCKET)
    cap = BS_N + ABSORBS
    check(bo.device.type == "cuda" and bo.dtype == torch.float32
          and bo.capacity == cap and bo._in_stream_regime()
          and not bo._factor_free(), f"BucketedGP at N = {BS_N}: capacity "
          f"{bo.capacity}, CUDA float32, the stream regime's predicate with "
          f"the masked posterior expected")
    secs, rescue = {}, {}

    def timed(name):
        fn = getattr(bo, name)

        def run(*a):
            ls0 = float(bo._hyps[-2]) if bo._hyps is not None else None
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t
            if name == "_update_posterior":
                rescue["steps"] = round((float(bo._hyps[-2]) - ls0)
                                        / LOG_SQRT10)
            return out
        setattr(bo, name, run)
    stages = ("_run_local_opt", "_update_posterior")
    for name in stages:
        timed(name)
    with factorizations() as fz:
        t0 = time.perf_counter()
        nll = bo.train(start)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    for name in stages:
        delattr(bo, name)
    train_counts = _counts(se_tile, chol_block)
    peak_train = torch.cuda.max_memory_allocated() / 1e9
    evals = int(bo.last_opt_result.evals)
    check(math.isfinite(nll) and bo._post_aux is None, f"bucketed_stream: "
          f"train() returned {nll}, post_aux {bo._post_aux}")
    check(train_counts["k1"] >= evals and train_counts["k3"] == fz.leaves()
          and train_counts["other"] == 0, f"bucketed_stream train: "
          f"{train_counts} for {evals} evaluations and blocked "
          f"factorizations of sizes {sorted(set(fz.sizes))}")
    hyp = bo.get_hyp()
    path = dict(train_counts)

    # the checks: train()'s NLL, the objective against GP's dense form,
    # _update_posterior's time (their launches apart)
    before = _counts(se_tile, chol_block)
    nll_again = bo.nll(hyp)
    vec = to_opt_vec(bo._tensor(bo._hyp_to_std(hyp)), False)
    f_b, g_b = bo._objective_closure()(vec)
    gp_form = "tiled" if exact.use_streamed_vg(bo.kernel, bo._x) else "dense"
    f_g, g_g = exact.objective_vg(bo.kernel, False, vec, bo._x, bo._ys)
    obj_rel = abs(float(f_b) - float(f_g)) / abs(float(f_g))
    obj_grad = float((g_b - g_g).abs().max() / g_g.abs().max())
    upd_ms = cuda_ms(torch, bo._update_posterior, iters=3, warm=1)
    check(np.array_equal(bo.get_hyp(), hyp), "_update_posterior at the "
          "fitted hyps inflated the noise")
    checks = _since(before, _counts(se_tile, chol_block))

    # 64 absorbs: BS_N -> capacity, each appended in O(N^2)
    L0 = bo._post[0]
    before = _counts(se_tile, chol_block)
    span_ms, wall_ms = [], []
    for i in range(ABSORBS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        bo.absorb(X[BS_N + i], y[BS_N + i])
        end.record()
        end.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        span_ms.append(start.elapsed_time(end))
        check(bo._post[0] is L0, f"bucketed_stream absorb {i}: the factor "
              f"was not appended in place")
    absorbs = _since(before, _counts(se_tile, chol_block))
    check(bo.num_train == cap and bo.trained, f"after {ABSORBS} absorbs: "
          f"{bo.num_train} rows, capacity {bo.capacity}")
    check(absorbs == {"k1": 0, "k2": ABSORBS, "k3": 0, "other": 0},
          f"{ABSORBS} absorbs launched {absorbs}: one K2 each expected")
    absorb_bound = 3 * cap * cap / 2 * 4 / PEAK_BYTES_S * 1e3
    path = _plus(path, absorbs)

    # the appended posterior against a fresh one at the same hyps, f64 and
    # f32, on the held-out rows
    before = _counts(se_tile, chol_block)
    b64 = BucketedGP(Xtr, ytr, bucket=N_BUCKET, dtype=torch.float64)
    b64._hyps = b64._tensor(hyp)
    b64._update_posterior()
    b64._trained = True
    for i in range(ABSORBS):
        b64.absorb(X[BS_N + i], y[BS_N + i])
    app32, app64 = _bo_pred(bo, Xte), _bo_pred(b64, Xte)
    # the mean from gp_tpu's two triangular solves on the appended factor,
    # beside absorb's chol_solve
    L = bo._post[0]
    tri = exact.predict_y(bo.kernel, bo._hyps, bo._x, solve_lower_t(
        L, solve_lower(L, bo._y - hyp_mean(bo._hyps))), bo._tensor(Xte))
    del L
    bo._update_posterior()
    b64._update_posterior()
    check(np.array_equal(bo.get_hyp(), hyp)
          and np.array_equal(b64.get_hyp(), hyp),
          "the refactorization at the fitted hyps inflated the noise")
    ref32, ref64 = _bo_pred(bo, Xte), _bo_pred(b64, Xte)
    del b64
    torch.cuda.empty_cache()
    checks = _plus(checks, _since(before, _counts(se_tile, chol_block)))
    gap64 = _rel_gap(app64, ref64, ref64)
    gap32 = _rel_gap(app32, ref32, ref64)
    ref_gap32 = _rel_gap(ref32, ref64, ref64)
    bound32 = [2 * g for g in ref_gap32]
    mu_to_f64 = {"appended_chol_solve": _rel_gap(app32, ref64, ref64)[0],
                 "appended_two_triangular_solves": _rel_gap(
                     (tri.double(),), ref64, ref64)[0],
                 "refactorized": ref_gap32[0]}

    # one absorb past capacity: the buffers grow, the standardization
    # refreshes, the factor is refactorized
    mu0 = bo._y_mu
    before = _counts(se_tile, chol_block)
    with factorizations() as fz:
        t0 = time.perf_counter()
        bo.absorb(X[cap], y[cap])
        torch.cuda.synchronize()
        fallback_s = time.perf_counter() - t0
    fallback = _since(before, _counts(se_tile, chol_block))
    path = _plus(path, fallback)
    check(bo.capacity == cap + N_BUCKET and bo.num_train == cap + 1
          and bo.trained and bo._y_mu != mu0, f"absorb past capacity: "
          f"capacity {bo.capacity}, {bo.num_train} rows, y_mu {bo._y_mu}")
    check(fallback["k3"] == fz.leaves() == _leaves(cap + 1) * len(fz.sizes)
          and fallback["k1"] == 0 and fallback["other"] == 0,
          f"absorb past capacity launched {fallback} for factorizations of "
          f"{fz.sizes}")

    # the predictions on the held-out rows
    before = _counts(se_tile, chol_block)
    t0 = time.perf_counter()
    mu, s2 = bo.batch_predict(Xte)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    mu_y = bo.batch_predict_y(Xte)
    yg, gy = bo.batch_predict_y_with_grad(Xte[:N_GRAD])
    sg, gs = bo.batch_predict_s2_with_grad(Xte[:N_GRAD])
    torch.cuda.synchronize()
    path = _plus(path, _since(before, _counts(se_tile, chol_block)))
    for k, v in {"mu": mu, "s2": s2, "mu_y": mu_y, "y_wg": yg, "gy": gy,
                 "s2_wg": sg, "gs2": gs}.items():
        check(bool(torch.isfinite(v).all()), f"bucketed_stream {k} not "
              f"finite")
    check(tuple(gs.shape) == (N_GRAD, STREAM_D), "gradient shape")
    rmse = _rmse(mu.cpu().numpy(), yte)
    rmse_const = _rmse(np.full_like(yte, ytr.mean()), yte)
    eps32 = float(torch.finfo(torch.float32).eps)
    res = {"n": BS_N, "d": STREAM_D, "bucket": N_BUCKET, "capacity": cap,
           "start": GOLDEN_STREAM, "nll": nll, "nll_again": nll_again, "evals": evals,
           "status": explain_result(bo.last_opt_result),
           "entered_search": bo.last_search is not None,
           "fit_s": secs["_run_local_opt"],
           "s_per_eval": secs["_run_local_opt"] / evals,
           "posterior_s": secs["_update_posterior"], "train_s": train_s,
           "rescue_steps": rescue["steps"], "hyp": hyp.tolist(),
           "c_floor": float(np.exp(2 * hyp[-2]) / (
               BS_N * eps32 * np.exp(2 * hyp[STREAM_D]))),
           "peak_gb_train": peak_train,
           "objective_vs_gp": {"gp_form": gp_form, "value_rel": obj_rel,
                               "grad_over_max": obj_grad, "limit": 1e-6},
           "update_posterior_ms": upd_ms,
           "absorb_ms_median": float(np.median(span_ms)),
           "absorb_ms_max": float(np.max(span_ms)),
           "absorb_host_ms_median": float(np.median(wall_ms)),
           "absorb_bound_ms": absorb_bound, "absorb_bound_by": "bytes",
           "appended_vs_refactorized": {
               "f64_rel_gap_mu_s2": gap64,
               "f32_rel_gap_mu_s2": gap32, "f32_bound_mu_s2": bound32,
               "f32_refactorization_gap_to_f64_mu_s2": ref_gap32,
               "f32_mu_gap_to_f64": mu_to_f64},
           "fallback_s": fallback_s, "fallback_launches": fallback,
           "capacity_after_fallback": bo.capacity,
           "predict_2000_s": predict_s, "rmse": rmse,
           "rmse_const": rmse_const,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "train_launches": train_counts, "absorb_launches": absorbs,
           "launches": path, "check_launches": checks,
           "seconds": time.perf_counter() - phase_t0}
    emit("bucketed_stream", **res)
    check(gp_form == "dense" and obj_rel <= 1e-6, f"bucketed_stream: the "
          f"masked objective {float(f_b)} against GP's {gp_form} form "
          f"{float(f_g)}: {obj_rel} beyond 1e-6")
    check(abs(nll - nll_again) <= 1e-6 * abs(nll), f"train() returned "
          f"{nll}, the masked NLL at its hyps is {nll_again}")
    check(gap32[0] <= bound32[0] and gap32[1] <= bound32[1],
          f"f32: absorbed posterior {gap32} from the refactorization's, "
          f"beyond {bound32}")
    check(rmse < 0.6 * rmse_const, f"bucketed_stream: held-out RMSE {rmse} "
          f"not below 0.6 of the constant predictor's {rmse_const}")
    check(path["k1"] > 0 and path["k2"] > 0 and path["other"] == 0,
          f"bucketed_stream: the path's launches {path}")
    x, h = bo._x, bo._hyps
    inv_l = torch.exp(-h[:STREAM_D])
    sf2 = torch.exp(2.0 * h[STREAM_D])
    k1 = _k1_record(torch, se_tile, x[:BS_N], inv_l, sf2, torch.full(
        (BS_N,), float(sf2 + torch.exp(2.0 * h[-2])), dtype=x.dtype,
        device=x.device))
    k2 = _k2_record(torch, se_tile, x[:1], x[:BS_N], inv_l, sf2)
    del bo
    torch.cuda.empty_cache()
    return {"launches": path, "k1": k1, "k2": k2}


# ---------------------------------------------------------------------------
# The QR solver strategies (module 12)
# ---------------------------------------------------------------------------

QR_PIVOT_N = 2000     # the qr_pivot fit's rows: N sequential pivot steps a
                      # factorization, each a handful of launches
QR_VALUE_TOL, QR_GRAD_TOL = 1e-9, 1e-7
F32_NLL_TOL = 1e-3


def _synced(torch, fn):
    """(fn(), seconds) with the card synchronized at both ends."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def qrp_bound_ms(n: int, dtype: str):
    """Least time of one pivoted QR of an n x n K with Q formed: K read
    once, Q and R written once (and perm), 8 n^3 / 3 flops (4 n^3 / 3 for
    R's reflections, 4 n^3 / 3 for Q accumulated backward, as LAPACK's
    geqp3 and orgqr count them)."""
    size = 4 if dtype == "float32" else 8
    t_bytes = (3 * n * n * size + 8 * n) / PEAK_BYTES_S * 1e3
    t_ops = 8 * n ** 3 / 3 / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _qrp_record(torch, qp, X, y, expect) -> dict:
    """csrc/qr_pivot.cu at the qr_pivot fit's K (its defaults, noise
    raised, float64) against qr_pivot_plain on the card: the pivots equal,
    the largest error of R and Q, times (CUDA events) and the bound."""
    from gp_tpu_torch import GP
    from gp_tpu_torch.ops.kernels import SE_ARD, get_k_noise
    gp = GP(X, y, dtype="float64")
    h = gp._tensor(parity_hyps(gp.get_default_hyps(), "se_ard", y))
    K = get_k_noise(SE_ARD)(h[:DIM + 1], torch.exp(2 * h[-2]), gp._x,
                            len(X))
    Q, R, p = qp.qr_pivot(K)
    Q0, R0, p0 = qp.qr_pivot_plain(K)
    err = max(float((R - R0).abs().max()), float((Q - Q0).abs().max()))
    n = len(X)
    expect.append((bool(torch.equal(p, p0))
                   and err <= 1e-11 * float(K.abs().max()),
                   f"qr_pivot kernel: pivots equal {torch.equal(p, p0)}, "
                   f"error {err} against its plain version"))
    bound_ms, by = qrp_bound_ms(n, "float64")
    return {"n": n, "dtype": "float64", "max_abs_err": err,
            "pivots_equal": bool(torch.equal(p, p0)),
            "ms": cuda_ms(torch, lambda: qp.qr_pivot(K), iters=5, warm=1),
            "plain_ms": cuda_ms(torch, lambda: qp.qr_pivot_plain(K),
                                iters=2, warm=1),
            "bound_ms": bound_ms, "bound_by": by}


def phase_qr_solvers(torch, Xtr, ytr, Xte, yte) -> dict:
    """The QR strategies on the card.  (1) At N = 8000, float64, the main
    path's data at its default hyps with the noise raised to 0.1 std(y)
    (parity_hyps): nll and the NLL+gradient (nll_vg_raw, QR's analytic
    gradient) for chol, qr and qr_pivot, each QR value within
    QR_VALUE_TOL of chol's (relative) and gradient within QR_GRAD_TOL of
    chol's largest entry, seconds each, and qr_pivot's factorization
    alone.  (2) GP(X[:8000], solver="qr").train() in float32 and
    GP(X[:QR_PIVOT_N], solver="qr_pivot").train() in float64 from the
    defaults (in float32 the pivoted QR's objective accepts a numerically
    singular K, the reference's logAbsDeterminant with no SPD test, and
    that fit descends to spurious negative NLLs and ends at RMSE 0.695 of
    the constant predictor's 0.878 on an H100, PERF.md §6), each
    with
    batch_predict and batch_predict_s2_with_grad, the launch counts set to
    0 before the model is built and read after: RMSE below 0.6 of the
    constant predictor's, the f32 NLL within F32_NLL_TOL of the f64 NLL at
    the fitted hyps (same solver), K1 at least once per evaluation, K2 in
    the predictions, and no K3 (nor K4, K5, another form).  (3) A
    rank-deficient K (300 rows, the last 100 duplicating the first) at a
    noise of 1e-9: qrp_ok false on the card, and set_k's sqrt(10) rescue
    (qr_pivot, float64) ends on the CPU's noise."""
    import numpy as np
    from gp_tpu_torch import GP
    from gp_tpu_torch.models import exact
    from gp_tpu_torch.ops import chol_block, se_tile
    from gp_tpu_torch.ops.kernels import SE_ARD, get_k_noise
    from gp_tpu_torch.ops import qr_pivot as qp
    from gp_tpu_torch.ops.qr_pivot import qr_pivot, qrp_ok
    from gp_tpu_torch.ops.solvers import get_solver
    from gp_tpu_torch.optim.lbfgsb import explain_result

    res = {"objective_f64": {}}
    # the checks run after the phase's line is printed
    expect = []
    gp64 = GP(Xtr, ytr, dtype="float64")
    hyp = gp64._tensor(parity_hyps(gp64.get_default_hyps(), "se_ard", ytr))
    x, y = gp64._x, gp64._y
    vals = {}
    for name in ("chol", "qr", "qr_pivot"):
        s = get_solver(name)
        nll, nll_s = _synced(torch, lambda: exact.nll(SE_ARD, hyp, x, y, s))
        (f, g), vg_s = _synced(torch, lambda: exact.nll_vg_raw(
            SE_ARD, hyp, x, y, solver=s))
        vals[name] = (float(nll), float(f), g.cpu().numpy())
        res["objective_f64"][name] = {"nll": float(nll), "nll_s": nll_s,
                                      "nll_vg": float(f), "nll_vg_s": vg_s}
    f_c, g_c = vals["chol"][1], vals["chol"][2]
    for name in ("qr", "qr_pivot"):
        n_q, f_q, g_q = vals[name]
        rel = max(abs(n_q - f_c), abs(f_q - f_c)) / abs(f_c)
        grad = float(np.max(np.abs(g_q - g_c)) / np.max(np.abs(g_c)))
        res["objective_f64"][name].update(value_rel_to_chol=rel,
                                          grad_rel_to_chol=grad)
        expect.append((rel <= QR_VALUE_TOL, f"{name}: f64 NLL {rel} from "
                       f"chol's (limit {QR_VALUE_TOL})"))
        expect.append((grad <= QR_GRAD_TOL, f"{name}: f64 gradient {grad} "
                       f"of chol's largest entry from it (limit "
                       f"{QR_GRAD_TOL})"))
    K = get_k_noise(SE_ARD)(hyp[:DIM + 1], torch.exp(2 * hyp[-2]), x,
                            N_TRAIN)
    (Q, R, perm), res["qr_pivot_factor_s"] = _synced(torch,
                                                     lambda: qr_pivot(K))
    expect.append((bool(qrp_ok(R)), "qr_pivot: K at the parity hyps refused"))
    del K, Q, R, perm, gp64
    torch.cuda.empty_cache()
    res["qr_pivot_kernel"] = _qrp_record(torch, qp, Xtr[:QR_PIVOT_N],
                                         ytr[:QR_PIVOT_N], expect)

    res["fits"] = {}
    for solver, n, dtype in (("qr", N_TRAIN, "float32"),
                             ("qr_pivot", QR_PIVOT_N, "float64")):
        se_tile.reset_launches()
        chol_block.reset_launches()
        qp.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gp = GP(Xtr[:n], ytr[:n], solver=solver, dtype=dtype)
        nll = gp.train()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        evals = int(gp.last_opt_result.evals)
        (mu, _), pred_s = _synced(torch, lambda: gp.batch_predict(Xte))
        s2, gs2 = gp.batch_predict_s2_with_grad(Xte[:N_GRAD])
        torch.cuda.synchronize()
        counts = _counts(se_tile, chol_block)
        counts["qr_pivot"] = qp.launches["qr_pivot"]
        chol_counts = dict(chol_block.launches)
        rmse = _rmse(mu.cpu().numpy(), yte)
        rmse_const = _rmse(np.full_like(yte, ytr[:n].mean()), yte)
        hyp_fit = gp.get_hyp()
        nll64, nll32 = (GP(Xtr[:n], ytr[:n], solver=solver,
                           dtype=dt).nll(hyp_fit)
                        for dt in ("float64", "float32"))
        rel = abs(nll32 - nll64) / abs(nll64)
        fit = {"n": n, "dtype": dtype, "nll": nll, "evals": evals,
               "fit_s": fit_s,
               "status": explain_result(gp.last_opt_result),
               "hyp": hyp_fit.tolist(),
               "s_per_eval": fit_s / evals, "predict_1000_s": pred_s,
               "rmse": rmse, "rmse_const": rmse_const,
               "nll_f32_at_fit": nll32, "nll_f64_at_fit": nll64,
               "f32_vs_f64": rel, "launches": counts,
               "chol_launches": chol_counts,
               "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
        res["fits"][solver] = fit
        for k, v in (("mu", mu), ("s2", s2), ("gs2", gs2)):
            expect.append((bool(torch.isfinite(v).all()),
                           f"{solver}: {k} not finite"))
        expect.append((rmse < 0.6 * rmse_const,
                       f"{solver} fit: held-out RMSE {rmse} not below 0.6 "
                       f"of the constant predictor's {rmse_const}"))
        expect.append((rel <= F32_NLL_TOL,
                       f"{solver}: f32 NLL {nll32} is {rel} from the f64 "
                       f"NLL {nll64} at the fitted hyps"))
        expect.append((counts["k1"] >= evals and counts["k2"] > 0
                       and (counts["qr_pivot"] >= evals)
                       == (solver == "qr_pivot"),
                       f"{solver}: K1/K2/qr_pivot launches {counts} for "
                       f"{evals} evaluations"))
        expect.append((sum(chol_counts.values()) == 0 and counts["other"] == 0,
              f"{solver}: K3-K5 or another form launched on the QR path: "
              f"{chol_counts}, {counts}"))
        del gp
        torch.cuda.empty_cache()

    # a rank-deficient K: duplicated rows at a 1e-9 noise
    Xd = np.array(Xtr[:300])
    Xd[200:] = Xd[:100]
    yd = np.array(ytr[:300])
    gp_d = GP(Xd, yd, dtype="float64", solver="qr_pivot")
    hyp_d = gp_d.get_default_hyps()
    hyp_d[-2] = math.log(1e-9)
    ends = {}
    for dev in ("cuda", "cpu"):
        xd = torch.tensor(Xd, dtype=torch.float64, device=dev)
        hd = torch.tensor(hyp_d, dtype=torch.float64, device=dev)
        Kd = get_k_noise(SE_ARD)(hd[:DIM + 1], torch.exp(2 * hd[-2]), xd,
                                 300)
        ok0 = bool(qrp_ok(qr_pivot(Kd)[1]))
        h, _, _, ok = exact.set_k(SE_ARD, hd, xd, torch.tensor(
            yd, dtype=torch.float64, device=dev), get_solver("qr_pivot"))
        ends[dev] = {"qrp_ok_at_start": ok0, "log_sn_end": float(h[-2]),
                     "ok": ok}
    res["rank_deficient"] = ends
    expect.append((not ends["cuda"]["qrp_ok_at_start"],
          "qr_pivot accepted the rank-deficient K on the card"))
    expect.append((ends["cuda"]["ok"] and ends["cuda"]["log_sn_end"]
          == ends["cpu"]["log_sn_end"],
          f"set_k's rescue (qr_pivot) ends at {ends}"))
    emit("qr_solvers", **res)
    for cond, what in expect:
        check(cond, what)
    return res


# ---------------------------------------------------------------------------
# The 1-D distributed layer (module 14, part 1)
# ---------------------------------------------------------------------------

# gp_tpu's dist_fit configuration (benchmarks/big_fit.py:299-336, record
# benchmarks/golden/tpu_dist_fit_n16384.json: final NLL -3271.83, RMSE
# 0.1675, 85 evaluations on its one-device "rows" mesh)
DIST_N, DIST_D = 16384, 10
DIST_TEST_N, DIST_TEST_SEED = 2000, 7
DIST_PRED_TOL = 1e-5
DIST_TIMEOUT = 900


def _dist_rank(mesh, ckpt: str) -> dict:
    """One process's part of the distributed phase (phase_distributed);
    returns its numbers, which the parent checks."""
    import numpy as np
    import torch
    from gp_tpu_torch import FITC, GP
    from gp_tpu_torch.models import exact
    from gp_tpu_torch.ops import chol_block, se_tile
    from gp_tpu_torch.parallel import pgp
    from gp_tpu_torch.utils.checkpoint import load_model
    from gp_tpu_torch.utils.synth import make_data

    out = {"rank": mesh.axis("rows").index, "device": str(mesh.device)}
    X, y = make_data(DIST_N, d=DIST_D, seed=SEED)
    Xte, yte = make_data(DIST_TEST_N, d=DIST_D, seed=DIST_TEST_SEED)

    # the path: the fit, the posterior, the predictions
    torch.cuda.reset_peak_memory_stats()
    se_tile.reset_launches()
    chol_block.reset_launches()
    t0 = time.perf_counter()
    gp = GP(X, y)
    nll = gp.train_distributed(mesh)
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    out["nll"] = nll
    out["evals"] = int(gp.last_opt_result.evals)
    mu, s2 = gp.batch_predict(Xte)
    s2g, gs2 = gp.batch_predict_s2_with_grad(Xte[:N_GRAD])
    yg, gy = gp.batch_predict_y_with_grad(Xte[:N_GRAD])
    torch.cuda.synchronize()
    out["launches"] = _counts(se_tile, chol_block)
    out["chol_launches"] = dict(chol_block.launches)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    out["finite"] = all(bool(torch.isfinite(t).all())
                        for t in (mu, s2, s2g, gs2, yg, gy))
    out["rmse"] = _rmse(mu.cpu().numpy(), yte)
    out["rmse_const"] = _rmse(np.full_like(yte, y.mean()), yte)
    out["hyp"] = gp.get_hyp().tolist()
    _, block, L, _ = gp._post_dist
    out["block"], out["local_rows"] = block, list(L.shape)

    # one evaluation at the fitted hyps: seconds and K2 launches
    k2 = se_tile.launches["se_matrix"]["se"]
    _, out["eval_s"] = _synced(torch, lambda: pgp.pnll_vg(
        gp.kernel, gp._hyps, gp._x, gp._y, mesh, block))
    out["k2_per_eval"] = se_tile.launches["se_matrix"]["se"] - k2
    out["local_blocks"] = L.shape[0]

    # float64 at the fitted hyps: the distributed objective against the
    # single card's, and both posteriors' predictions
    def f64(m):
        m._hyps = m._tensor(gp.get_hyp())
        return m
    d64, s64 = f64(GP(X, y, dtype="float64")), f64(GP(X, y, dtype="float64"))
    (fd, gd), out["eval_f64_s"] = _synced(torch, lambda: pgp.pnll_vg(
        d64.kernel, d64._hyps, d64._x, d64._y, mesh, block))
    fs, gs = exact.nll_vg_raw(s64.kernel, s64._hyps, s64._x, s64._y)
    # the single card's float32 objective at the same point, for scale
    _, out["eval_single_card_s"] = _synced(torch, lambda: exact.nll_vg_raw(
        gp.kernel, gp._hyps, gp._x, gp._y))
    out["f64_value_rel"] = abs(float(fd) - float(fs)) / abs(float(fs))
    out["f64_grad_rel"] = float((gd - gs).abs().max() / gs.abs().max())
    hd, Ld, ad, okd = pgp.pset_k(d64.kernel, d64._hyps, d64._x, d64._y,
                                 mesh, block=block)
    d64._hyps, d64._post_dist, d64._trained = hd, (mesh, block, Ld, ad), True
    s64._update_posterior()
    s64._trained = True
    gaps = {}
    for label, call in (("batch_predict", lambda m: m.batch_predict(Xte)),
                        ("batch_predict_s2_with_grad",
                         lambda m: m.batch_predict_s2_with_grad(
                             Xte[:N_GRAD]))):
        for i, (a, b) in enumerate(zip(call(d64), call(s64))):
            gaps[f"{label}[{i}]"] = float((a - b).abs().max()
                                          / b.abs().max())
    out["pred_f64_rel"] = gaps
    del d64, s64, Ld, hd, ad
    # the float32 posteriors' gap, for the record
    s32 = GP(X, y)
    s32._hyps = gp._hyps.clone()
    s32._update_posterior()
    s32._trained = True
    mu_s, s2_s = s32.batch_predict(Xte)
    out["pred_f32_rel"] = [float((mu - mu_s).abs().max() / mu_s.abs().max()),
                           float((s2 - s2_s).abs().max() / s2_s.abs().max())]
    del s32
    torch.cuda.empty_cache()

    # save_model (gathered to the mesh's first process), load_model,
    # restore_distributed: the predictions bit for bit
    (_, out["save_s"]) = _synced(torch, lambda: gp.save(ckpt))
    torch.distributed.barrier()
    r = load_model(ckpt)
    r.restore_distributed(mesh)
    mu_r, s2_r = r.batch_predict(Xte)
    out["checkpoint_bitwise"] = bool(torch.equal(mu_r, mu)
                                     and torch.equal(s2_r, s2))
    del r, gp
    torch.cuda.empty_cache()

    # FITC with the rows sharded: the sparse_fitc data and inducing rows
    Xf, yf = make_data(N_TRAIN + N_TEST, d=DIM, seed=SEED)
    Xf, yf = Xf[:N_TRAIN], yf[:N_TRAIN]
    se_tile.reset_launches()
    chol_block.reset_launches()
    t0 = time.perf_counter()
    fitc = FITC(Xf, yf)
    fitc.set_inducing(Xf[-N_INDUCING:])
    nll_f = fitc.train_distributed(mesh)
    torch.cuda.synchronize()
    out["fitc"] = {"fit_s": time.perf_counter() - t0, "nll": nll_f,
                   "evals": int(fitc.last_opt_result.evals),
                   "launches": _counts(se_tile, chol_block)}
    single = FITC(Xf, yf)
    single.set_inducing(Xf[-N_INDUCING:])
    single._jitter_u = fitc._jitter_u
    n_single = single.nll(fitc.get_hyp())
    out["fitc"]["nll_single_card"] = n_single
    out["fitc"]["rel"] = abs(nll_f - n_single) / abs(n_single)
    return out


def _se_k1_inputs(torch, X, y, dtype):
    """K1's inputs at rows X in dtype, at the SE-ARD defaults of (X, y)."""
    from gp_tpu_torch import GP
    gp = GP(X, y, dtype=dtype)
    h = gp._tensor(gp.get_default_hyps())
    inv_l = torch.exp(-h[:DIM])
    sf2 = torch.exp(2 * h[DIM])
    return gp._x, inv_l, sf2, sf2 + torch.exp(2 * h[-2]).expand(len(X))


def _dist_k2_record(torch, se_tile, res) -> dict:
    """K2 at the distributed gradient's row-block shape, (B, N_pad) x d,
    float32, at the fitted hyps: the first block's rows against every row
    of the padded data."""
    from gp_tpu_torch.utils.synth import make_data
    X, _ = make_data(DIST_N, d=DIST_D, seed=SEED)
    h = torch.tensor(res["hyp"], dtype=torch.float32, device="cuda")
    x = torch.zeros((res["local_rows"][2], DIST_D), dtype=torch.float32,
                    device="cuda")
    x[:DIST_N] = torch.tensor(X, dtype=torch.float32, device="cuda")
    return _k2_record(torch, se_tile, x[:res["block"]], x,
                      torch.exp(-h[:DIST_D]), torch.exp(2 * h[DIST_D]))


def phase_distributed(torch) -> dict:
    """GP.train_distributed at gp_tpu's dist_fit configuration (N = 16384,
    d = 10, held out make_data(2000, 10, seed=7)) on an NCCL mesh of
    P = min(cards, 4) processes (parallel.mesh.spawn), float32, from the
    defaults: the launch counts set to 0 in each process just before its
    model is built and read after the predictions.  Checks, in each
    process: RMSE below 0.6 of the constant predictor's; at the fitted
    hyps the float64 distributed NLL within 1e-9 (relative) of the single
    card's nll_vg_raw and the gradient within 1e-7 of its largest entry;
    the float64 distributed posterior's batch_predict and
    batch_predict_s2_with_grad within DIST_PRED_TOL (relative to the
    largest entry) of the single-card model's at the same hyps; save_model
    -> load_model -> restore_distributed predictions bit for bit; K2 once
    for the build plus once per local block for the gradient in an
    evaluation, no K1 or K3 on the path; every process the same NLL; then
    FITC.train_distributed at N = 8000, M = 512 (the sparse_fitc data),
    float64, its NLL within 1e-9 of the single-card FITC's at its hyps."""
    import tempfile
    from gp_tpu_torch.parallel.mesh import spawn

    P = min(torch.cuda.device_count(), 4)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = spawn(_dist_rank, P, "cuda", DIST_TIMEOUT,
                     (os.path.join(tmp, "dist.npz"),))
        wall = time.perf_counter() - t0
    r0 = outs[0]
    res = {"processes": P, "phase_s": wall, **{k: v for k, v in r0.items()}}
    emit("distributed", **res)
    for r in outs:
        tag = f"rank {r['rank']}"
        check(r["nll"] == r0["nll"], f"{tag}: NLL {r['nll']} != {r0['nll']}")
        check(r["finite"], f"{tag}: non-finite predictions")
        check(r["rmse"] < 0.6 * r["rmse_const"], f"{tag}: RMSE {r['rmse']} "
              f"not below 0.6 of the constant predictor's {r['rmse_const']}")
        check(r["f64_value_rel"] <= 1e-9 and r["f64_grad_rel"] <= 1e-7,
              f"{tag}: f64 distributed objective off the single card's: "
              f"{r['f64_value_rel']}, {r['f64_grad_rel']}")
        check(max(r["pred_f64_rel"].values()) <= DIST_PRED_TOL,
              f"{tag}: distributed predictions off: {r['pred_f64_rel']}")
        check(r["checkpoint_bitwise"], f"{tag}: restored posterior differs")
        n = r["launches"]
        check(n["k2"] > 0 and n["k1"] == 0 and n["k3"] == 0
              and n["other"] == 0, f"{tag}: launches {n}")
        check(r["k2_per_eval"] == 1 + r["local_blocks"],
              f"{tag}: {r['k2_per_eval']} K2 launches an evaluation for "
              f"{r['local_blocks']} local blocks")
        f = r["fitc"]
        check(f["rel"] <= 1e-9, f"{tag}: distributed FITC NLL {f['nll']} "
              f"off the single card's {f['nll_single_card']}")
        check(f["launches"]["k2"] > 0 and f["launches"]["k1"] == 0
              and f["launches"]["k3"] == 0, f"{tag}: FITC launches "
              f"{f['launches']}")
    return res


# ---------------------------------------------------------------------------
# The 2-D grid layer (module 14, part 2)
# ---------------------------------------------------------------------------

def grid_shape(P: int) -> tuple:
    """The ("rowg", "colg") grid of P processes: (1, 1) on one card (gp_tpu's
    record configuration), (2, 2) on four, (1, P) otherwise."""
    return (2, 2) if P == 4 else (1, P)


def _grid_rank(mesh, tmp: str) -> dict:
    """One process's part of the grid phase (phase_grid); returns its
    numbers, which the parent checks."""
    import numpy as np
    import torch
    from gp_tpu_torch import GP
    from gp_tpu_torch.models import exact
    from gp_tpu_torch.ops import chol_block, se_tile
    from gp_tpu_torch.parallel import pchol2d
    from gp_tpu_torch.parallel.mesh import make_mesh_grid
    from gp_tpu_torch.utils.checkpoint import (load_model,
                                               load_model_sharded,
                                               save_model_sharded)
    from gp_tpu_torch.utils.synth import make_data

    m = make_mesh_grid(*grid_shape(mesh.shape["rows"]))
    g = pchol2d.grid_of(m)
    out = {"rank": m.whole.index, "grid": [g.pr, g.pc], "rc": [g.r, g.c]}
    X, y = make_data(DIST_N, d=DIST_D, seed=SEED)
    Xte, yte = make_data(DIST_TEST_N, d=DIST_D, seed=DIST_TEST_SEED)

    # the path: the fit, the posterior, the predictions
    torch.cuda.reset_peak_memory_stats()
    se_tile.reset_launches()
    chol_block.reset_launches()
    t0 = time.perf_counter()
    gp = GP(X, y)
    nll = gp.train_distributed(m)
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    out["nll"] = nll
    out["evals"] = int(gp.last_opt_result.evals)
    mu, s2 = gp.batch_predict(Xte)
    s2g, gs2 = gp.batch_predict_s2_with_grad(Xte[:N_GRAD])
    yg, gy = gp.batch_predict_y_with_grad(Xte[:N_GRAD])
    torch.cuda.synchronize()
    out["launches"] = _counts(se_tile, chol_block)
    out["chol_launches"] = dict(chol_block.launches)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    out["finite"] = all(bool(torch.isfinite(t).all())
                        for t in (mu, s2, s2g, gs2, yg, gy))
    out["rmse"] = _rmse(mu.cpu().numpy(), yte)
    out["rmse_const"] = _rmse(np.full_like(yte, y.mean()), yte)
    out["hyp"] = gp.get_hyp().tolist()
    _, block, L, _ = gp._post_dist
    out["block"], out["local_tiles"] = block, list(L.shape)

    # one evaluation at the fitted hyps: seconds and K2 launches
    k2 = se_tile.launches["se_matrix"]["se"]
    _, out["eval_s"] = _synced(torch, lambda: pchol2d.pnll_vg2d(
        gp.kernel, gp._hyps, gp._x, gp._y, m, block))
    out["k2_per_eval"] = se_tile.launches["se_matrix"]["se"] - k2

    # float64 at the fitted hyps: the grid objective against the single
    # card's, and both posteriors' predictions
    def f64(model):
        model._hyps = model._tensor(gp.get_hyp())
        return model
    d64, s64 = f64(GP(X, y, dtype="float64")), f64(GP(X, y, dtype="float64"))
    (fd, gd), out["eval_f64_s"] = _synced(torch, lambda: pchol2d.pnll_vg2d(
        d64.kernel, d64._hyps, d64._x, d64._y, m, block))
    fs, gs = exact.nll_vg_raw(s64.kernel, s64._hyps, s64._x, s64._y)
    out["f64_value_rel"] = abs(float(fd) - float(fs)) / abs(float(fs))
    out["f64_grad_rel"] = float((gd - gs).abs().max() / gs.abs().max())
    hd, Ld, ad, okd = pchol2d.pset_k2d(d64.kernel, d64._hyps, d64._x,
                                       d64._y, m, block=block)
    d64._hyps, d64._post_dist, d64._trained = hd, (m, block, Ld, ad), True
    s64._update_posterior()
    s64._trained = True
    gaps = {}
    for label, call in (("batch_predict", lambda md: md.batch_predict(Xte)),
                        ("batch_predict_s2_with_grad",
                         lambda md: md.batch_predict_s2_with_grad(
                             Xte[:N_GRAD]))):
        for i, (a, b) in enumerate(zip(call(d64), call(s64))):
            gaps[f"{label}[{i}]"] = float((a - b).abs().max()
                                          / b.abs().max())
    out["pred_f64_rel"] = gaps
    del d64, s64, Ld, hd, ad
    torch.cuda.empty_cache()

    # save_model (gathered to the grid's first process) -> load_model ->
    # restore_distributed, and save_model_sharded -> load_model_sharded:
    # the predictions bit for bit
    path, shards = os.path.join(tmp, "grid.npz"), os.path.join(tmp, "shards")
    _, out["save_s"] = _synced(torch, lambda: gp.save(path))
    torch.distributed.barrier()
    r, out["load_s"] = _synced(torch, lambda: load_model(path))
    _, out["restore_s"] = _synced(torch, lambda: r.restore_distributed(m))
    mu_r, s2_r = r.batch_predict(Xte)
    out["checkpoint_bitwise"] = bool(torch.equal(mu_r, mu)
                                     and torch.equal(s2_r, s2))
    del r
    _, out["save_sharded_s"] = _synced(torch, lambda: save_model_sharded(
        gp, shards))
    r, out["load_sharded_s"] = _synced(torch, lambda: load_model_sharded(
        shards, m))
    mu_r, s2_r = r.batch_predict(Xte)
    out["sharded_bitwise"] = bool(torch.equal(mu_r, mu)
                                  and torch.equal(s2_r, s2))
    out["file_bytes"] = os.path.getsize(path) if out["rank"] == 0 else None
    return out


def _grid_k2_record(torch, se_tile, res) -> dict:
    """K2 at the grid build's shape, the first process's (nbr B, nbc B)
    tiles x d, float32, at the fitted hyps."""
    from gp_tpu_torch.utils.synth import make_data
    X, _ = make_data(DIST_N, d=DIST_D, seed=SEED)
    nbr, nbc, B, _ = res["local_tiles"]
    pr, pc = res["grid"]
    h = torch.tensor(res["hyp"], dtype=torch.float32, device="cuda")
    x = torch.zeros((nbr * B * pr, DIST_D), dtype=torch.float32,
                    device="cuda")
    x[:DIST_N] = torch.tensor(X, dtype=torch.float32, device="cuda")
    xb = x.view(nbr, pr, B, DIST_D)[:, 0].reshape(-1, DIST_D)
    xc = x.view(nbc, pc, B, DIST_D)[:, 0].reshape(-1, DIST_D)
    return _k2_record(torch, se_tile, xb, xc, torch.exp(-h[:DIST_D]),
                      torch.exp(2 * h[DIST_D]))


def phase_grid(torch, distributed: dict) -> dict:
    """GP.train_distributed on a ("rowg", "colg") grid (parallel/pchol2d.py)
    at gp_tpu's grid_fit configuration (benchmarks/big_fit.py:339-377:
    N = 16384, d = 10, held out make_data(2000, 10, seed=7)), float32,
    from the defaults, on grid_shape(min(cards, 4)) NCCL processes: the
    launch counts set to 0 in each process just before its model is built
    and read after the predictions.  Checks, in each process: RMSE below
    0.6 of the constant predictor's; every process the same NLL; at the
    fitted hyps the float64 grid NLL within 1e-9 (relative) of the single
    card's nll_vg_raw and its gradient within 1e-7 of the largest entry;
    the float64 grid posterior's batch_predict and
    batch_predict_s2_with_grad within DIST_PRED_TOL of the single card's;
    save_model -> load_model -> restore_distributed and
    save_model_sharded -> load_model_sharded predictions bit for bit; K2
    twice an evaluation (the tile build and its rebuild under autograd),
    no K1, K3, K4 or K5 on the path.  The 1-D distributed phase's and the
    single card's seconds an evaluation are printed beside the grid's."""
    import tempfile
    from gp_tpu_torch.parallel.mesh import spawn

    P = min(torch.cuda.device_count(), 4)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = spawn(_grid_rank, P, "cuda", DIST_TIMEOUT, (tmp,))
        wall = time.perf_counter() - t0
    r0 = outs[0]
    res = {"processes": P, "phase_s": wall, **r0,
           "eval_s_distributed_1d": distributed["eval_s"],
           "eval_s_single_card": distributed["eval_single_card_s"],
           "processes_1d": distributed["processes"]}
    emit("grid", **res)
    for r in outs:
        tag = f"rank {r['rank']}"
        check(r["nll"] == r0["nll"], f"{tag}: NLL {r['nll']} != {r0['nll']}")
        check(r["finite"], f"{tag}: non-finite predictions")
        check(r["rmse"] < 0.6 * r["rmse_const"], f"{tag}: RMSE {r['rmse']} "
              f"not below 0.6 of the constant predictor's {r['rmse_const']}")
        check(r["f64_value_rel"] <= 1e-9 and r["f64_grad_rel"] <= 1e-7,
              f"{tag}: f64 grid objective off the single card's: "
              f"{r['f64_value_rel']}, {r['f64_grad_rel']}")
        check(max(r["pred_f64_rel"].values()) <= DIST_PRED_TOL,
              f"{tag}: grid predictions off: {r['pred_f64_rel']}")
        check(r["checkpoint_bitwise"] and r["sharded_bitwise"],
              f"{tag}: a restored grid posterior differs")
        n = r["launches"]
        check(n["k2"] > 0 and n["k1"] == 0 and n["k3"] == 0
              and n["other"] == 0, f"{tag}: launches {n}")
        check(r["k2_per_eval"] == 2, f"{tag}: {r['k2_per_eval']} K2 launches "
              f"an evaluation, not 2")
    return res


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
        bucketed = phase_bucketed_bo(torch, Xtr, ytr, Xte, yte)
        phase_checkpoint(torch, {"main_path": paths["se_ard"]["gp"],
                                 "bucketed_bo": bucketed["model"]}, Xte)
        cli = phase_cli(torch, Xtr, ytr, Xte, paths["se_ard"]["gp"],
                        sparse["FITC"]["model"])
        qr = phase_qr_solvers(torch, Xtr, ytr, Xte, yte)
        distributed = phase_distributed(torch)
        grid = phase_grid(torch, distributed)
        stream = {"stream_at_golden": phase_stream_at_golden(torch),
                  "stream_fit": phase_stream_fit(torch)}
        bucketed_stream = phase_bucketed_stream(torch)
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
        # the BO serving path (its own launches: train, the absorbs, the
        # fallback, add_data's train, the predictions; K2's time at
        # absorb's (1, N) shape) and the CLI's child processes (their
        # counts, printed by CLI_CHILD)
        k2 = timed[(kernel_name("se", False), "float32", 1.0)]
        bo_k2 = bucketed["k2_absorb"]
        bo = bucketed["launches"]
        gp_cli = cli["cli_gp"]
        fitc_cli = cli["cli_fitc"]
        check(fitc_cli["se_tile"]["se_matrix_diag"]["se"] == 0
              and sum(fitc_cli["chol_block"].values()) == 0,
              f"cli_fitc launched K1 or K3: {fitc_cli}")
        for label, n1, n2, n3, rec2 in (
                ("bucketed_bo", bo["k1"], bo["k2"], bo["k3"], bo_k2),
                ("cli_gp", gp_cli["se_tile"]["se_matrix_diag"]["se"],
                 gp_cli["se_tile"]["se_matrix"]["se"],
                 gp_cli["chol_block"]["chol_inv_reg"], k2)):
            check(n1 > 0 and n2 > 0 and n3 > 0,
                  f"K1, K2 or K3 not launched on {label}")
            kernels.append(row(
                "se_tile_diag", src, "gp_tpu/ops/pallas_kernels.py:89", k1,
                n1, label, device_ms=k1["device_ms"], form="se",
                shape=[N_TRAIN, N_TRAIN, DIM], dtype="float32"))
            kernels.append(row(
                "se_tile", src, "gp_tpu/ops/pallas_kernels.py:71", rec2, n2,
                label, device_ms=rec2["device_ms"], form="se",
                shape=[rec2["m"], rec2["n"], rec2["d"]], dtype="float32"))
            kernels.append(row(
                "chol_inv", chol_src, "gp_tpu/ops/pallas_chol.py:180", k3,
                n3, label, design="chol_inv_reg", shape=[LEAF, LEAF],
                dtype="float32", library=k3["library"]))
        n2 = fitc_cli["se_tile"]["se_matrix"]["se"]
        check(n2 > 0, "K2 not launched on cli_fitc")
        rec = sparse["FITC"]["k2"]["kxu"]
        kernels.append(row(
            "se_tile", src, "gp_tpu/ops/pallas_kernels.py:71", rec, n2,
            "cli_fitc", device_ms=rec["device_ms"], form="se",
            shape=[rec["m"], rec["n"], rec["d"]], dtype="float64"))
        # the stream regime, by dtype (stream_fit runs in float32): K1's
        # times at its (51200, 51200) x 10 build, K2's at the row tiles'
        # (2048, 51200) x 10, K3's at b = 128
        golden = stream["stream_at_golden"]
        fit = {"float32": stream["stream_fit"]["launches"]}
        for label, by_dtype in (("stream_at_golden", golden["launches"]),
                                ("stream_fit", fit)):
            for dt, n in by_dtype.items():
                check(n["k1"] > 0 and n["k2"] > 0 and n["k3"] > 0,
                      f"K1, K2 or K3 not launched on {label} ({dt})")
                rec1, rec2 = golden["k1"][dt], golden["k2"][dt]
                rec3 = chol_timed[("chol_inv", dt, LEAF, None)]
                kernels.append(row(
                    "se_tile_diag", src, "gp_tpu/ops/pallas_kernels.py:89",
                    rec1, n["k1"], label, device_ms=rec1["device_ms"],
                    form="se", shape=[rec1["m"], rec1["n"], rec1["d"]],
                    dtype=dt))
                kernels.append(row(
                    "se_tile", src, "gp_tpu/ops/pallas_kernels.py:71", rec2,
                    n["k2"], label, device_ms=rec2["device_ms"], form="se",
                    shape=[rec2["m"], rec2["n"], rec2["d"]], dtype=dt))
                kernels.append(row(
                    "chol_inv", chol_src, "gp_tpu/ops/pallas_chol.py:180",
                    rec3, n["k3"], label, design="chol_inv_reg",
                    shape=[LEAF, LEAF], dtype=dt, library=rec3["library"]))
        # BucketedGP at the stream configuration: K1 at its build
        # (32832, 32832) x 10, K2 at absorb's (1, 32832), K3 at b = 128
        bs = bucketed_stream
        rec3 = chol_timed[("chol_inv", "float32", LEAF, None)]
        check(bs["launches"]["k3"] > 0, "K3 not launched on bucketed_stream")
        for name, line, rec, n in (
                ("se_tile_diag", 89, bs["k1"], bs["launches"]["k1"]),
                ("se_tile", 71, bs["k2"], bs["launches"]["k2"])):
            kernels.append(row(
                name, src, f"gp_tpu/ops/pallas_kernels.py:{line}", rec, n,
                "bucketed_stream", device_ms=rec["device_ms"], form="se",
                shape=[rec["m"], rec["n"], rec["d"]], dtype="float32"))
        kernels.append(row(
            "chol_inv", chol_src, "gp_tpu/ops/pallas_chol.py:180", rec3,
            bs["launches"]["k3"], "bucketed_stream", design="chol_inv_reg",
            shape=[LEAF, LEAF], dtype="float32", library=rec3["library"]))
        # the QR fits (K1's time at each fit's N and dtype, K2's at the
        # main shape) and the distributed paths (K2 in float32 at the
        # gradient's row blocks (B, N_pad) x 10, the build's one launch of
        # all local rows beside them; FITC's K2 in float64)
        from gp_tpu_torch.ops import se_tile
        for solver, fit in qr["fits"].items():
            n, dt = fit["n"], fit["dtype"]
            rec1 = k1 if (n, dt) == (N_TRAIN, "float32") else _k1_record(
                torch, se_tile, *_se_k1_inputs(torch, Xtr[:n], ytr[:n], dt))
            rec2 = timed[(kernel_name("se", False), dt, 1.0)]
            kernels.append(row(
                "se_tile_diag", src, "gp_tpu/ops/pallas_kernels.py:89",
                rec1, fit["launches"]["k1"], f"qr_solvers ({solver})",
                device_ms=rec1["device_ms"], form="se",
                shape=[n, n, DIM], dtype=dt))
            kernels.append(row(
                "se_tile", src, "gp_tpu/ops/pallas_kernels.py:71", rec2,
                fit["launches"]["k2"], f"qr_solvers ({solver})",
                device_ms=rec2["device_ms"], form="se",
                shape=[rec2["m"], rec2["n"], rec2["d"]], dtype=dt))
        rec = qr["qr_pivot_kernel"]
        n = qr["fits"]["qr_pivot"]["launches"]["qr_pivot"]
        check(n > 0, "the qr_pivot kernel was not launched on its fit")
        kernels.append(row(
            "qr_pivot", "gp_tpu_torch/csrc/qr_pivot.cu",
            "gp_tpu/ops/qr_pivot.py:27", rec, n, "qr_solvers (qr_pivot)",
            shape=[rec["n"], rec["n"]], dtype=rec["dtype"],
            pallas_kernel=False))
        rec = _dist_k2_record(torch, se_tile, distributed)
        kernels.append(row(
            "se_tile", src, "gp_tpu/ops/pallas_kernels.py:71", rec,
            distributed["launches"]["k2"], "distributed",
            device_ms=rec["device_ms"], form="se",
            shape=[rec["m"], rec["n"], rec["d"]], dtype="float32",
            per_evaluation=distributed["k2_per_eval"]))
        rec = _grid_k2_record(torch, se_tile, grid)
        kernels.append(row(
            "se_tile", src, "gp_tpu/ops/pallas_kernels.py:71", rec,
            grid["launches"]["k2"], "grid", device_ms=rec["device_ms"],
            form="se", shape=[rec["m"], rec["n"], rec["d"]],
            dtype="float32", per_evaluation=grid["k2_per_eval"]))
        rec = sparse["FITC"]["k2"]["kxu"]
        kernels.append(row(
            "se_tile", src, "gp_tpu/ops/pallas_kernels.py:71", rec,
            distributed["fitc"]["launches"]["k2"], "distributed_fitc",
            device_ms=rec["device_ms"], form="se",
            shape=[rec["m"], rec["n"], rec["d"]], dtype="float64"))
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
