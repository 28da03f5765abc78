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
  build      seconds to build the kernels, ptxas register/spill report
  unported_bounds  the bound of each TPU kernel still to port (K3-K5)
  kernel     each kernel in each covariance form (se, m52, m32, rq at
             alpha 0.7 and 50) against its plain PyTorch version, float32
             and float64, at the main path's shape (N = 8000, d = 24) and
             at ragged shapes: max abs error, the largest error over its
             entry's rounding bound, CUDA-event times, bound
  main_path  GP(X, y).train() on CUDA float32 at N = 8000, d = 24, then
             batch_predict and both *_with_grad: NLL, evaluations, fit
             seconds, evaluations per second, held-out RMSE, launches
  breakdown  CUDA-event times of the stages of one NLL+gradient evaluation
  f64_fit    the same fit in float64 on the card; the f32 NLL against
             the f64 NLL at the f32 fit's hyps; how each fit stopped, the
             f64 gradient at the f32 end point, and where the two fits'
             trajectories part
  fd_check   central finite differences (f64) against the input gradients
  main_path_matern52, breakdown_matern52, fd_check_matern52
             the same three for GP(X, y, kernel="matern52"), whose
             gradient is the vjp of the K1 build at Q = K^-1 - a a^T
  main_path_matern32, main_path_rq
             the fit and predictions with the other two kernel families
  cpu_parity the card against the CPU in f64 on a 600-point posterior,
             for se_ard and the six Matern/RQ specs

Each main path runs with the launch counts set to 0 just before it and
read just after; it must have gone through its own form of K1 and K2 and
no other.  Then comes the `kernels` line (every ported kernel and form,
what it replaces, its launches on its main path, times and bound) and,
last, the result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3
# 3.35 TB/s; float32 67 TFLOP/s and float64 34 TFLOP/s outside the tensor
# cores (the SE tile kernel uses plain FMAs).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

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


def chol_bound_ms(b: int, inverse: bool):
    """Least time of one b x b float32 block Cholesky, the kernels still
    to port (gp_tpu/ops/pallas_chol.py): b^3 / 3 flops for the factor (K4
    _chol_kernel, K5 _chol_panel_kernel), as much again for the inverse
    (K3 _chol_inv_kernel); the block read once, L (and L^-1) written once.
    Plain FMAs: TF32 tensor cores are off in the port."""
    flops = (2 if inverse else 1) * b ** 3 / 3
    nbytes = 4 * b * b * (3 if inverse else 2)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_unported_bounds() -> None:
    """Bounds of the TPU kernels not ported yet, at gp_tpu's block sizes
    (b = 128: blocked.py's base_block; b = 1024: its panel)."""
    bounds = {}
    for name, inverse in (("K3_chol_inv", True), ("K4_chol", False),
                          ("K5_chol_panel", False)):
        for b in (128, 1024):
            ms, by = chol_bound_ms(b, inverse)
            bounds[f"{name}_b{b}"] = {"bound_ms": ms, "bound_by": by}
    emit("unported_bounds", dtype="float32", bounds=bounds)


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    check(smi.returncode == 0 and line != "", "nvidia-smi gave no card")
    print(line, flush=True)
    info = {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": line,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "capability": list(torch.cuda.get_device_capability(0))}
    emit("device", **info)
    return info


def phase_build() -> None:
    from gp_tpu_torch.ops import _build
    seconds, log = _build.build(ptxas_info=True)
    report = [ln.strip() for ln in log.splitlines()
              if "registers" in ln or "spill" in ln]
    emit("build", seconds=seconds, sources=list(_build.SOURCES),
         ptxas=report)


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
                        rec.update(ms=cuda_ms(torch, kern),
                                   plain_ms=cuda_ms(torch, plain, iters=5),
                                   bound_ms=bound_ms, bound_by=by)
                        timed[(name, dname, alpha)] = rec
                    emit("kernel", **rec)
                    del out, ref
                torch.cuda.empty_cache()
    return timed


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

        def recorded(kernel, noise_free, vec, *rest):
            self.stamps.append(time.perf_counter())
            f, g = self.objective_vg(kernel, noise_free, vec, *rest)
            self.rows.append((f.detach(), vec[-2].detach()))
            return f, g
        exact.objective_vg = recorded
        return self

    def __exit__(self, *exc):
        self.exact.objective_vg = self.objective_vg

    def take(self):
        """(f, log sn) per evaluation as float64 lists; clears the record."""
        import torch
        f = torch.stack([r[0].double().cpu() for r in self.rows])
        ls = torch.stack([r[1].double().cpu() for r in self.rows])
        self.rows = []
        return f.tolist(), ls.tolist()


def _launched(se_tile) -> dict:
    return {w: dict(by_form) for w, by_form in se_tile.launches.items()}


def phase_main_path(torch, Xtr, ytr, Xte, yte, kernel: str = "se_ard",
                    phase: str = "main_path") -> dict:
    """GP(X, y, kernel).train() and the predictions on the card, with the
    launch counts set to 0 just before and read just after: K1 and K2 of
    the kernel's form, and no other form, must carry the path."""
    import numpy as np
    from gp_tpu_torch import GP
    from gp_tpu_torch.ops import se_tile
    from gp_tpu_torch.optim.lbfgsb import explain_result

    form = FORM_OF[kernel]
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 2**30
    se_tile.reset_launches()
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
    res = {"kernel": kernel, "form": form, "nll": nll, "evals": evals,
           "fit_s": fit_s, "evals_per_s": evals / fit_s,
           "status": explain_result(gp.last_opt_result),
           "rmse": rmse, "rmse_const": rmse_const,
           "predict_1000_s": pred_s, "launches": launches,
           "launches_train": after_train, "k2_launches_by_call": counts,
           "call_s": call_s,
           "hyp_moved": moved, "hyp": hyp.tolist(),
           "eval_clock": eval_clock, "memory_gb": mem_gb}
    emit(phase, **res)
    return {"gp": gp, "nll": nll, "launches": launches, "evals": evals,
            "form": form}


def phase_breakdown(torch, gp, phase: str = "breakdown") -> None:
    """Stages of one NLL+gradient evaluation at the fitted hyps.  A spec
    with a structured gradient contraction (SE) times it; any other times
    Q = K^-1 - alpha alpha^T and the vjp of the K1 build at Q, the two
    steps of the objective's generic branch."""
    from gp_tpu_torch.models.base import hyp_mean, hyp_sn2
    from gp_tpu_torch.models.exact import objective_vg
    from gp_tpu_torch.ops.blocked import spd_inv_from_chol
    from gp_tpu_torch.ops.chol import cholesky

    kern, x, y = gp.kernel, gp._x, gp._ys
    hyp = gp._tensor(gp._hyp_to_std(gp.get_hyp()))
    nc = kern.num_hyp(x.shape[1])
    chyp, sn2, n = hyp[:nc], hyp_sn2(hyp), x.shape[0]
    K = kern.k_noise(chyp, sn2, x, n)
    L = cholesky(K)
    Kinv = spd_inv_from_chol(L)
    r = y - hyp_mean(hyp)
    alpha = Kinv @ r
    vec = gp._tensor(gp._hyp_to_std(gp.get_hyp()))
    stages = {
        "k1_build": lambda: kern.k_noise(chyp, sn2, x, n),
        "cholesky": lambda: cholesky(K),
        "cholesky_inverse": lambda: spd_inv_from_chol(L),
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
    # device memory one evaluation takes beyond what is already held
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    objective_vg(kern, False, vec, x, y)
    torch.cuda.synchronize()
    extra_gb = (torch.cuda.max_memory_allocated() - held) / 2**30
    emit(phase, kernel=kern.name, n=n, dtype=str(x.dtype).split(".")[-1],
         ms=ms, objective_extra_memory_gb=extra_gb)


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
    from gp_tpu_torch.models.exact import objective_vg
    from gp_tpu_torch.ops import se_tile
    from gp_tpu_torch.optim.lbfgsb import explain_result

    se_tile.reset_launches()
    with traced_fits() as trace:
        t0 = time.perf_counter()
        gp = GP(Xtr, ytr, dtype=torch.float64)
        nll = gp.train()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = _launched(se_tile)
        f64, ls64 = trace.take()
        # the f32 fit again, for its trajectory (the main path's run is
        # left as a user runs it)
        again = GP(Xtr, ytr)
        nll32_again = again.train()
        f32, ls32 = trace.take()
    evals = int(gp.last_opt_result.evals)
    nll64_at_32 = gp.nll(gp32.get_hyp())
    rel = abs(nll32 - nll64_at_32) / abs(nll64_at_32)
    mu, _ = gp.batch_predict(Xte)

    # how the f32 fit stopped, and the f64 objective at its end point
    r32 = gp32.last_opt_result
    vec32 = r32.x.double()
    _, g_at = objective_vg(gp.kernel, False, vec32, gp._x, gp._ys)
    apart = lambda tol: next(
        (i + 1 for i, (a, b) in enumerate(zip(f32, f64))
         if abs(a - b) > tol * abs(b)), None)

    def pick(f, ls):
        evs = sorted({i for i in (1, 10, 20, 40, 80, 120, 150)
                      if i <= len(f)} | {len(f)})
        return {"eval": evs, "f_std": [f[i - 1] for i in evs],
                "log_sn_std": [ls[i - 1] for i in evs]}
    emit("f64_fit", nll=nll, evals=evals, fit_s=fit_s, launches=launches,
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
         first_eval_apart={"1e-6": apart(1e-6), "1e-3": apart(1e-3)},
         trajectory={"f32": pick(f32, ls32), "f64": pick(f64, ls64)})
    check(math.isfinite(nll), "f64 NLL not finite")
    check(launches["se_matrix_diag"]["se"] >= evals,
          "f64 fit did not go through the f64 K1 kernel")
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
        phase_unported_bounds()
        X, y = make_data(N_TRAIN + N_TEST, d=DIM, seed=SEED)
        Xtr, ytr, Xte, yte = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], \
            y[N_TRAIN:]
        timed = phase_kernels(torch, Xtr)
        paths = {"se_ard": phase_main_path(torch, Xtr, ytr, Xte, yte)}
        phase_breakdown(torch, paths["se_ard"]["gp"])
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
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "bound_by": rec["bound_by"],
                    # no single PyTorch call computes a covariance matrix
                    "library_ms": None, "form": form, "p1": rec["p1"],
                    "main_path": kernel,
                    "shape": [rec["m"], rec["n"], rec["d"]],
                    "dtype": "float32"})
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
