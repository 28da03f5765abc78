#!/usr/bin/env python3
"""Where the blocked factorization's time goes on a CUDA card.

    python3 scripts/blocked_profile.py [--n 8000] [--reps 3]
    python3 scripts/blocked_profile.py --count-ops [--n 8000]
    python3 scripts/blocked_profile.py --leaf-sweep
    python3 scripts/blocked_profile.py --k4-panel
    python3 scripts/blocked_profile.py --k5-panel

Builds the SE covariance of chip_smoke.py's data (unit sf2, lengthscales
std sqrt(d), noise 0.1) at N rows and runs the blocked route's factor
(`chol.blocked_factor`: pad once, K3 leaves), in float32 and float64.
Prints one JSON line per dtype:
  - CUDA-event milliseconds of the factor and of the leaf chain alone (the
    route's K3 launches, one after another, on one leaf-sized block), and
    the factor's K3 launches by C entry;
  - the device time of one factorization by kernel name, from
    torch.profiler over `reps` factorizations (the top entries), and the
    device's busy share of the profiled window.
The route against the library one, per stage and per evaluation, is
chip_smoke.py's `breakdown` and `route_sweep`.  Needs one CUDA card;
exits non-zero without one.

--count-ops needs no card: it counts the aten calls one blocked
factorization and one blocked inverse dispatch at N rows (on the meta
device, the leaves replaced by empty outputs) and prints them by name.

--leaf-sweep times K3 alone against its block size b (4 to 128, the
register kernel's range), per dtype: one CUDA graph of 50 launches on
one SPD block, replayed, so no host time comes between the launches.
Microseconds per launch, and per step of the b-step loop.

--k4-panel times K4 (`cholesky_block`) at b = 256, 512 and 1024, in its
blocked form (panels of 64), beside `cholesky_ex`, per dtype; then a
b = 1024 call's device time by kernel name (torch.profiler), summed by
part (leaves, panel solves, trailing updates), and the gaps: the call's
CUDA-event time less its kernels' device time.
--k5-panel does the same for K5 (`cholesky_panel`) at w = 32 and 128:
leaves, panel updates, panel solves and gaps.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def device_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--count-ops", action="store_true")
    ap.add_argument("--leaf-sweep", action="store_true")
    ap.add_argument("--k4-panel", action="store_true")
    ap.add_argument("--k5-panel", action="store_true")
    args = ap.parse_args()
    import torch
    if args.count_ops:
        print(json.dumps(count_ops(torch, args.n)))
        return 0
    if not torch.cuda.is_available():
        print("blocked_profile: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import cuda_ms, smi_line
    if args.leaf_sweep:
        for dtype in (torch.float32, torch.float64):
            print(json.dumps(leaf_sweep(torch, dtype, cuda_ms, smi_line)),
                  flush=True)
        return 0
    if args.k4_panel or args.k5_panel:
        name, widths = (("cholesky_block", (None,)) if args.k4_panel
                        else ("cholesky_panel", (32, 128)))
        for dtype in (torch.float32, torch.float64):
            print(json.dumps(panel_profile(torch, dtype, cuda_ms, smi_line,
                                           name, widths)), flush=True)
        return 0
    from gp_tpu_torch.ops import chol as chol_mod
    from gp_tpu_torch.ops import chol_block as cb
    from gp_tpu_torch.ops import se_tile
    from gp_tpu_torch.utils.synth import make_data

    X, _ = make_data(args.n, d=24, seed=42)
    n = args.n
    for dtype in (torch.float32, torch.float64):
        x = torch.as_tensor(X, dtype=dtype, device="cuda")
        inv_l = 1.0 / (x.std(dim=0) * math.sqrt(x.shape[1]))
        dvals = torch.full((n,), 1.1, dtype=dtype, device="cuda")
        K = se_tile.se_matrix_diag(inv_l, 1.0, x, dvals)
        factor = lambda: chol_mod.blocked_factor(K)
        _, _, blk = factor()
        cb.reset_launches()
        factor()
        torch.cuda.synchronize()
        k3 = {e: cb.launches[e] for e in ("chol_inv_reg", "chol_inv")}
        leaves = sum(k3.values())
        leaf = 128
        Kb = K[:leaf, :leaf].contiguous()

        def leaf_chain():
            for _ in range(leaves):
                cb.chol_inv(Kb)
        ms = {"route_factor": cuda_ms(torch, factor, iters=5, warm=1),
              "leaf_chain": cuda_ms(torch, leaf_chain, iters=5, warm=1)}
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                factor()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_kernel = []
        busy = 0.0
        for e in prof.key_averages():
            us = device_us(e)
            if us <= 0 or getattr(e, "device_type", None) is not None \
                    and "CUDA" not in str(e.device_type):
                continue
            by_kernel.append((us / args.reps, e.count // args.reps, e.key))
            busy += us
        by_kernel.sort(reverse=True)
        print(json.dumps({
            "dtype": str(dtype).split(".")[-1], "n": n,
            "padded": n + (-n % blk), "block": blk, "base_block": leaf,
            "leaves": leaves, "k3_launches": k3, "ms": ms,
            "profiled_factorizations": args.reps,
            "device_busy_share": busy / wall_us,
            "device_ms_per_factor_by_kernel": [
                {"kernel": k[:90], "ms": us / 1e3, "calls": c}
                for us, c, k in by_kernel[:14]],
            "card": torch.cuda.get_device_name(0),
            "nvidia_smi": smi_line()}), flush=True)
        del K
        torch.cuda.empty_cache()
    return 0


def leaf_sweep(torch, dtype, cuda_ms, smi_line, launches: int = 50) -> dict:
    """Microseconds of one K3 launch at each block size b, from a CUDA
    graph of `launches` launches on one SPD block."""
    from gp_tpu_torch.ops import chol_block as cb
    us = {}
    for b in (4, 32, 64, 96, 128):
        g = torch.Generator(device="cuda").manual_seed(b)
        A = torch.randn(b, b, generator=g, dtype=dtype, device="cuda")
        K = A @ A.T / b + torch.eye(b, dtype=dtype, device="cuda")
        cb.chol_inv(K)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                cb.chol_inv(K)
        us[b] = cuda_ms(torch, graph.replay, iters=10, warm=2) * 1e3 \
            / launches
    return {"dtype": str(dtype).split(".")[-1], "kernel": cb.k3_entry(128),
            "launches_per_graph": launches, "us_per_launch": us,
            "us_per_step": {b: t / b for b, t in us.items()},
            "card": torch.cuda.get_device_name(0), "nvidia_smi": smi_line()}


# the parts of a K4 or K5 call, by a piece of their kernels' names
PARTS = {"chol_inv_reg_alias": "leaves", "chol_panel_solve": "panel solves",
         "chol_trailing": "trailing updates",
         "chol_panel_update": "panel updates", "chol_copy_lower": "copy"}


def panel_profile(torch, dtype, cuda_ms, smi_line, name: str, widths,
                  reps: int = 5) -> dict:
    """K4's or K5's (`name`, at each panel width in `widths`, None for
    K4) CUDA-event milliseconds against b, beside cholesky_ex's, and a
    b = 1024 call's device time by kernel and by part, with the gaps."""
    from torch.profiler import ProfilerActivity, profile
    from gp_tpu_torch.ops import chol_block as cb
    fn = getattr(cb, name)
    call = lambda K, w: fn(K) if w is None else fn(K, w)
    label = lambda w: name if w is None else f"{name} w={w}"
    ms = {}
    for b in (256, 512, 1024):
        g = torch.Generator(device="cuda").manual_seed(b)
        A = torch.randn(b, b, generator=g, dtype=torch.float64,
                        device="cuda")
        K = (A @ A.T + b * torch.eye(b, dtype=torch.float64,
                                     device="cuda")).to(dtype)
        ms[b] = {label(w): cuda_ms(torch, lambda w=w: call(K, w))
                 for w in widths}
        ms[b]["cholesky_ex"] = cuda_ms(
            torch, lambda: torch.linalg.cholesky_ex(K))
    b1024 = {}
    for w in widths:
        call(K, w)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call(K, w)
            torch.cuda.synchronize()
        by_kernel = sorted(
            ((device_us(e) / reps, e.count // reps, e.key)
             for e in prof.key_averages() if device_us(e) > 0
             and (getattr(e, "device_type", None) is None
                  or "CUDA" in str(e.device_type))), reverse=True)
        parts = {}
        for us, calls, key in by_kernel:
            part = next((v for k, v in PARTS.items() if k in key), None)
            if part is not None:
                ms_, n = parts.get(part, (0.0, 0))
                parts[part] = (ms_ + us / 1e3, n + calls)
        kernels_ms = sum(v[0] for v in parts.values())
        call_ms = ms[1024][label(w)]
        b1024[label(w)] = {
            "call_ms": call_ms, "kernels_ms": kernels_ms,
            "gaps_ms": call_ms - kernels_ms,
            "by_part": {k: {"ms": v[0], "launches": v[1]}
                        for k, v in parts.items()},
            "by_kernel": [{"kernel": k[:90], "ms": us / 1e3, "calls": c}
                          for us, c, k in by_kernel[:8]]}
    return {"dtype": str(dtype).split(".")[-1], "kernel": name, "ms": ms,
            "panel": cb.K4_PANEL if name == "cholesky_block" else None,
            "b1024_device": b1024,
            "card": torch.cuda.get_device_name(0), "nvidia_smi": smi_line()}


def count_ops(torch, n: int) -> dict:
    """aten calls of one blocked factorization and one blocked inverse
    (the route's shapes, no data: meta tensors, leaves stubbed)."""
    import collections
    from torch.utils._python_dispatch import TorchDispatchMode
    from gp_tpu_torch.ops import blocked as bl
    from gp_tpu_torch.ops import chol as chol_mod

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.calls[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    leaf = bl.chol_block.chol_inv
    bl.chol_block.chol_inv = lambda K: (torch.empty_like(K),
                                        torch.empty_like(K))
    try:
        K = torch.empty(n, n, device="meta")
        with Count() as fac:
            L, Td, blk = chol_mod.blocked_factor(K)
        with Count() as inv:
            bl.spd_inv_from_chol(L, block=blk, diag_inv=Td)
    finally:
        bl.chol_block.chol_inv = leaf
    return {"n": n, "block": blk,
            "factor_calls": sum(fac.calls.values()),
            "factor_by_name": dict(fac.calls.most_common()),
            "inverse_calls": sum(inv.calls.values()),
            "inverse_by_name": dict(inv.calls.most_common())}


if __name__ == "__main__":
    sys.exit(main())
