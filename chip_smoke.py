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
  kernel     each kernel against its plain PyTorch version, float32 and
             float64, at the main path's shape (N = 8000, d = 24) and at
             ragged shapes: max abs error, the largest error over its
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
  cpu_parity the card against the CPU in f64 on a 600-point posterior

then the `kernels` line (every ported kernel, what it replaces, its
launches on the main path, times and bound) and, last, the result line
{"ok": true, "device": {...}}.
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


def se_bound_ms(m: int, n: int, d: int, dtype: str, symmetric: bool):
    """Least time of one SE build: each input read once, the output
    written once; 2 m n d flops of cross term, 2 (m + n) d of norms and
    5 per output (expansion, clamp, scale, exp)."""
    size = 4 if dtype == "float32" else 8
    rows_in = m if symmetric else m + n
    nbytes = size * (rows_in * d + m * n + 1 + (m if symmetric else 0))
    flops = 2 * m * n * d + 2 * rows_in * d + 5 * m * n
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


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
    """Each kernel against its plain version; times at the main shape.

    Every entry is held to its own rounding bound (se_tile.rounding_bound),
    a relative error of about eps (2 d + 4) (|a|^2 + |b|^2): 1.3e-5 at the
    main shape in float32.  The inverse lengthscales 1 / (std sqrt(d)) put
    |a - b|^2 near 2, so the entries are O(sf2) and a wrong entry shows."""
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
            k2 = lambda: se_tile.se_matrix(inv_l, sf2, x1, x2)
            p2 = lambda: se_tile.se_matrix_plain(inv_l, sf2, x1, x2)
            k1 = lambda: se_tile.se_matrix_diag(inv_l, sf2, xs, dvals)
            p1 = lambda: se_tile.se_matrix_diag_plain(inv_l, sf2, xs, dvals)
            for name, kern, plain, rows, xa, xb in (
                    ("se_tile_diag", k1, p1, (xs.shape[0],) * 2, xs, xs),
                    ("se_tile", k2, p2, (m, n), x1, x2)):
                out = kern()
                torch.cuda.synchronize()
                ref = plain()
                check(tuple(out.shape) == rows, f"{name} shape")
                bound = se_tile.rounding_bound(inv_l, sf2, xa, xb, ref)
                err = (out - ref).abs()
                ratio = float((err / bound).max())
                check(math.isfinite(ratio) and ratio <= 1.0,
                      f"{name} {dname} {m}x{n}x{d}: an entry is off by "
                      f"{ratio} times its rounding bound")
                if name == "se_tile_diag":
                    check(bool(torch.equal(out.diagonal(), dvals)),
                          f"{name} {dname}: diagonal is not dvals")
                rec = {"kernel": name, "dtype": dname, "m": rows[0],
                       "n": rows[1], "d": d, "max_abs_err": float(err.max()),
                       "max_err_over_bound": ratio,
                       "median_bound_over_k": float(
                           (bound / ref.abs()).median()),
                       "median_k_over_sf2": float(ref.median()) / 1.3}
                del bound, err
                if label == "main":
                    sym = name == "se_tile_diag"
                    bound_ms, by = se_bound_ms(rows[0], rows[1], d, dname,
                                               sym)
                    rec.update(ms=cuda_ms(torch, kern),
                               plain_ms=cuda_ms(torch, plain, iters=5),
                               bound_ms=bound_ms, bound_by=by)
                    timed[(name, dname)] = rec
                emit("kernel", **rec, launches=dict(se_tile.launches))
            del out, ref
            torch.cuda.empty_cache()
    return timed


def _rmse(a, b) -> float:
    import numpy as np
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def phase_main_path(torch, Xtr, ytr, Xte, yte) -> dict:
    import numpy as np
    from gp_tpu_torch import GP
    from gp_tpu_torch.ops import se_tile
    from gp_tpu_torch.optim.lbfgsb import explain_result

    se_tile.reset_launches()
    t0 = time.perf_counter()
    gp = GP(Xtr, ytr)
    check(gp.device.type == "cuda" and gp.dtype == torch.float32,
          "GP(X, y) must default to CUDA float32")
    nll = gp.train()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    after_train = dict(se_tile.launches)
    evals = int(gp.last_opt_result.evals)

    counts = {}

    def counted(label, fn):
        before = se_tile.launches["se_matrix"]
        out = fn()
        torch.cuda.synchronize()
        counts[label] = se_tile.launches["se_matrix"] - before
        return out

    t1 = time.perf_counter()
    mu, s2 = counted("batch_predict", lambda: gp.batch_predict(Xte))
    pred_s = time.perf_counter() - t1
    yg, gy = counted("batch_predict_y_with_grad",
                     lambda: gp.batch_predict_y_with_grad(Xte[:N_GRAD]))
    sg, gs = counted("batch_predict_s2_with_grad",
                     lambda: gp.batch_predict_s2_with_grad(Xte[:N_GRAD]))
    launches = dict(se_tile.launches)

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
    check(rmse < 0.6 * rmse_const, f"held-out RMSE {rmse} not below 0.6 "
          f"of the constant predictor's {rmse_const}")
    check(after_train["se_matrix_diag"] >= evals,
          f"K1 launched {after_train['se_matrix_diag']} times for {evals} "
          f"objective evaluations")
    check(after_train["se_matrix"] >= 1, "K2 not launched in set_k")
    for label, c in counts.items():
        check(c >= 1, f"K2 not launched in {label}")
    res = {"nll": nll, "evals": evals, "fit_s": fit_s,
           "evals_per_s": evals / fit_s,
           "status": explain_result(gp.last_opt_result),
           "rmse": rmse, "rmse_const": rmse_const,
           "predict_1000_s": pred_s, "launches": launches,
           "launches_train": after_train, "k2_launches_by_call": counts,
           "hyp_moved": moved}
    emit("main_path", **res)
    return {"gp": gp, "nll": nll, "launches": launches, "evals": evals}


def phase_breakdown(torch, gp) -> None:
    """Stages of one NLL+gradient evaluation at the fitted hyps."""
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
        "grad_contraction": lambda: kern.k_noise_vjp_q(
            chyp, sn2, x, n, K, Kinv, alpha),
        "objective_total": lambda: objective_vg(kern, False, vec, x, y),
    }
    emit("breakdown", n=n, dtype=str(x.dtype).split(".")[-1],
         ms={k: cuda_ms(torch, f, iters=5, warm=1)
             for k, f in stages.items()})


class traced_fits:
    """Records each objective evaluation's value and log sigma_n (in the
    standardized units the optimizer sees) of the fits run inside it.
    The records stay on the card until the fit ends: no extra sync."""

    def __enter__(self):
        from gp_tpu_torch.models import exact
        self.exact, self.objective_vg = exact, exact.objective_vg
        self.rows = []

        def recorded(kernel, noise_free, vec, *rest):
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
        launches = dict(se_tile.launches)
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
    check(launches["se_matrix_diag"] >= evals,
          "f64 fit did not go through the f64 K1 kernel")
    check(rel <= 1e-3, f"f32 NLL {nll32} not within 1e-3 of the f64 NLL "
          f"{nll64_at_32} at the same hyps")
    return gp


def phase_fd(torch, gp64, Xte) -> None:
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
    emit("fd_check", h=h, rel_err_y=ry, rel_err_s2=rs, tol=1e-5)
    check(ry <= 1e-5 and rs <= 1e-5,
          f"input gradients vs central differences: {ry}, {rs} > 1e-5")


def phase_cpu_parity(torch, gp64, Xtr, ytr, Xte) -> None:
    """The card against the CPU (plain versions, LAPACK) in f64, on a
    600-point posterior at the f64 fit's hyps."""
    import numpy as np
    from gp_tpu_torch.utils.convert import gp_from_state
    state = {"x": Xtr[:600], "y": ytr[:600], "hyps": gp64.get_hyp(),
             "kernel": "se_ard", "dtype": "float64"}
    gc = gp_from_state(state, device="cuda")
    gh = gp_from_state(state, device="cpu")
    pts = Xte[:200]
    rel = lambda a, b: float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
    errs = {"nll": abs(gc.nll() - gh.nll()) / abs(gh.nll())}
    for name in ("batch_predict", "batch_predict_y_with_grad",
                 "batch_predict_s2_with_grad"):
        for i, (a, b) in enumerate(zip(getattr(gc, name)(pts),
                                       getattr(gh, name)(pts))):
            errs[f"{name}[{i}]"] = rel(a.cpu().numpy(), b.numpy())
    emit("cpu_parity", n=600, rel_err=errs, tol=1e-8)
    check(max(errs.values()) <= 1e-8,
          f"card vs CPU (f64) beyond 1e-8: {errs}")


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
    from gp_tpu_torch.utils.synth import make_data
    try:
        dev = phase_device(torch)
        phase_build()
        X, y = make_data(N_TRAIN + N_TEST, d=DIM, seed=SEED)
        Xtr, ytr, Xte, yte = X[:N_TRAIN], y[:N_TRAIN], X[N_TRAIN:], \
            y[N_TRAIN:]
        timed = phase_kernels(torch, Xtr)
        main_res = phase_main_path(torch, Xtr, ytr, Xte, yte)
        phase_breakdown(torch, main_res["gp"])
        gp64 = phase_f64(torch, Xtr, ytr, Xte, yte, main_res["gp"],
                         main_res["nll"])
        phase_fd(torch, gp64, Xte)
        phase_cpu_parity(torch, gp64, Xtr, ytr, Xte)
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        return 1
    src = "gp_tpu_torch/csrc/se_tile.cu"
    replaces = {"se_tile_diag": "gp_tpu/ops/pallas_kernels.py:89",
                "se_tile": "gp_tpu/ops/pallas_kernels.py:71"}
    wrapper = {"se_tile_diag": "se_matrix_diag", "se_tile": "se_matrix"}
    kernels = []
    for name in ("se_tile_diag", "se_tile"):
        rec = timed[(name, "float32")]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name],
            "launches": main_res["launches"][wrapper[name]],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            # no single PyTorch call computes the SE covariance matrix
            "library_ms": None,
            "shape": [rec["m"], rec["n"], rec["d"]], "dtype": "float32"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
