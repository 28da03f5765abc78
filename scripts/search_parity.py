#!/usr/bin/env python3
"""The port's MVMO search and train() from an INF start against gp_tpu's,
on the CPU, with gp_tpu's draws replayed into the port.

    JAX_PLATFORMS=cpu python3 scripts/search_parity.py [--n 1000]
        [--dtype float64|float32] [--chunk C] [--start inf|defaults]

Exact SE-ARD GP on utils/synth.make_data(n + 500, d=24, seed=42), the
last 500 rows held out.  The start is gp_tpu's INF start (every length
scale at -200 in float32, -800 in float64: 1/l overflows) or the
defaults; num = num_hyp * 50 candidates in chunks of C (default: the
model's, gp_tpu's formula; chip_smoke's N = 8000 gives 3).  It runs

  A  the port's mvmo_search on the port's objective,
  B  the port's mvmo_search on gp_tpu's objective (its one-candidate
     function vmapped over each chunk),
  C  gp_tpu's mvmo_search_hosted (one jitted generation per execution),
  D  gp_tpu's mvmo_search (the whole search as one jitted scan; train()
     runs this one),

and prints each one's best f (standardized units).  It rebuilds A's and
B's archive after every generation from their objective calls, traces C's
step for step (gp_tpu's own _mvmo_gen), and prints, for A and B against
C, the first generation whose archives differ by more than 1e-6 of the box,
the largest difference before it (the rounding of the two sides' own
arithmetic: torch's and XLA's exp, sums and batched factors) and the
archives' best values there.
Last, the port's GP.train and gp_tpu's GP.train from the same start (each
with its own search, the port's on replayed draws): final NLL and held-out
RMSE beside the constant predictor's.  A run takes one to a few minutes.
"""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import gp_tpu  # noqa: E402
from gp_tpu.optim import multistart as jm  # noqa: E402
from gp_tpu_torch import GP  # noqa: E402
from gp_tpu_torch.optim import multistart as tm  # noqa: E402
from gp_tpu_torch.utils.synth import make_data  # noqa: E402
from test_torch_multistart import Replay  # noqa: E402


def mvmo_draws(key, num, chunk, nv, dtype, archive=25):
    """gp_tpu's mvmo_search draws in the model's dtype (multistart.py:
    177-188, 109-114)."""
    key, k0 = jax.random.split(key)
    out = [("u", jax.random.uniform(k0, (archive - 1, nv), dtype))]
    for kt in jax.random.split(key, max(num // chunk, 1)):
        ku, km, _ = jax.random.split(kt, 3)
        out += [("u", jax.random.uniform(ku, (chunk, nv), dtype)),
                ("b", jax.random.bernoulli(km, 0.5, (chunk, nv)))]
    return out


class Logged:
    """The objective with every call's candidates and values kept."""

    def __init__(self, fun):
        self.fun, self.calls = fun, []

    def __call__(self, vecs):
        v = self.fun(vecs)
        self.calls.append((vecs.clone(), v.clone()))
        return v


def port_archives(log, archive=25):
    """The port's archive (x, f) after the seed and after each generation,
    rebuilt from its logged objective calls with mvmo_search's merge."""
    calls = [(c.double(), torch.where(torch.isfinite(v), v.double(),
                                      torch.full_like(v.double(), np.inf)))
             for c, v in log.calls]
    xs, fs, k = [], [], 0
    while sum(c.shape[0] for c in xs) < archive:
        xs.append(calls[k][0])
        fs.append(calls[k][1])
        k += 1
    xa, fa = torch.cat(xs), torch.cat(fs)
    out = [(xa, fa)]
    for child, fc in calls[k:]:
        order = torch.argsort(fa, stable=True)
        x_all = torch.cat([xa[order], child])
        f_all = torch.cat([fa[order], fc])
        keep = torch.argsort(f_all, stable=True)[:archive]
        xa, fa = x_all[keep], f_all[keep]
        out.append((xa, fa))
    return out


def gp_tpu_archives(fj, key, lb, ub, x0, num, chunk, archive=25):
    """gp_tpu's mvmo_search_hosted, step for step, with its archive (x, f)
    kept after the seed and after each generation."""
    dt = x0.dtype
    lb_f, width = jm._mvmo_box(lb, ub)
    n_gen = max(num // chunk, 1)
    key, k0 = jax.random.split(key)
    z0 = jnp.clip((x0 - lb_f) / width, 0.0, 1.0)
    za = jnp.concatenate([z0[None, :], jax.random.uniform(
        k0, (archive - 1, x0.shape[0]), dt)], axis=0)
    fun_j = jax.jit(fj)
    fa = jnp.stack([fun_j(lb_f + za[i] * width) for i in range(archive)])
    fa = jnp.where(jnp.isfinite(fa), fa, jm.INF)
    gen = jm._mvmo_gen(fj, lb_f, width, n_gen, chunk, archive, 0.5, 20.0,
                       dt, x0.shape[0])
    gen_j = jax.jit(lambda st, t, k: gen(st, (t, k))[0])
    state, out = (za, fa), []
    for t, kt in enumerate([None] + list(jax.random.split(key, n_gen))):
        if kt is not None:
            state = gen_j(state, jnp.asarray(t - 1, jnp.int32), kt)
        out.append((torch.from_numpy(np.array(lb_f + state[0] * width,
                                              np.float64)),
                    torch.from_numpy(np.array(state[1], np.float64))))
    return out, torch.from_numpy(np.array(width, np.float64))


def parting(a, b, width, tol):
    """The first generation whose archives differ by more than 1e-6 of the
    box (in x), the largest difference before it, the entries each archive
    then holds that the other does not (rank, f), the count of exact ties
    and the smallest nonzero relative gap among the port's finite archive
    values before that generation, and how many entries of each archive
    lie within tol (relative) of its best there: the best's ties."""
    before = 0.0
    for t, ((xa, fa), (xb, fb)) in enumerate(zip(a, b)):
        dz = float(((xa - xb).abs() / width).max())
        if dz > 1e-6:
            only = []
            for side, (X, F), Y in (("port", (xa, fa), xb),
                                    ("gp_tpu", (xb, fb), xa)):
                d = ((X[:, None, :] - Y[None, :, :]).abs()
                     / width).amax(-1).amin(1)
                only += [{"side": side, "rank": k, "f": float(F[k])}
                         for k in torch.nonzero(d > 1e-6).flatten().tolist()]
            fp = a[t - 1][1] if t else fa
            fs = torch.sort(fp[torch.isfinite(fp)]).values
            gaps = (fs[1:] - fs[:-1]) / fs[1:].abs()
            return {"generation": t, "of": len(a) - 1,
                    "max_dz_before": before, "only_in_one": only,
                    "ties_before": int((gaps == 0).sum()),
                    "min_nonzero_rel_gap_before": float(gaps[gaps > 0].min())
                    if bool((gaps > 0).any()) else None,
                    "ties_of_best": [
                        int(((F - F.min()).abs() <= tol * F.min().abs())
                            .sum()) for F in (fa, fb)], "tie_tol": tol,
                    "port_best_f": [float(v) for v in fa[:4]],
                    "gp_tpu_best_f": [float(v) for v in fb[:4]]}
        before = max(before, dz)
    return {"generation": None, "max_dz": before}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--dtype", default="float64",
                    choices=("float64", "float32"))
    ap.add_argument("--chunk", type=int, default=0)
    ap.add_argument("--start", default="inf", choices=("inf", "defaults"))
    args = ap.parse_args()
    n, dname = args.n, args.dtype
    tdt, jdt = getattr(torch, dname), getattr(jnp, dname)
    X, y = make_data(n + 500, d=24, seed=42)
    Xtr, ytr, Xte, yte = X[:n], y[:n], X[n:], y[n:]
    gt = GP(Xtr, ytr, device="cpu", dtype=dname)
    gj = gp_tpu.GP(Xtr, ytr, dtype=dname)
    start = gt.get_default_hyps()
    if args.start == "inf":
        start[:24] = -200.0 if dname == "float32" else -800.0
        assert gt.nll(start) == np.inf and gj.nll(start) == np.inf
    num = gt.num_hyp * 50
    chunk = args.chunk or gt._multistart_chunk()
    lb, ub = gj._std_bounds()
    x0 = gj._hyp_to_std(start)
    _, key = jax.random.split(jax.random.PRNGKey(0))   # gp_tpu's _next_key
    draws = lambda: Replay(mvmo_draws(key, num, chunk, gt.num_hyp, jdt))
    box = [torch.tensor(np.asarray(a), dtype=tdt) for a in (lb, ub, x0)]
    print(f"n {n}, {dname}, start {args.start}, candidates "
          f"{tm.mvmo_evaluations(num, chunk)}, chunk {chunk}")

    fa = Logged(gt._multistart_objective())
    xa, f_a = tm.mvmo_search(fa, draws(), *box, num=num, chunk=chunk)
    fj = gj._multistart_objective()
    vj = jax.jit(jax.vmap(fj))
    fb = Logged(lambda v: torch.from_numpy(
        np.array(vj(jnp.asarray(v.numpy())))))
    xb, f_b = tm.mvmo_search(fb, draws(), *box, num=num, chunk=chunk)
    j_box = [jnp.asarray(a, jdt) for a in (lb, ub, x0)]
    xc, f_c = jm.mvmo_search_hosted(fj, key, *j_box, num=num, chunk=chunk)
    arch_c, width = gp_tpu_archives(fj, key, *j_box, num, chunk)
    tol = 16 * torch.finfo(tdt).eps     # a tie: a few last bits apart
    _, f_d = jm.mvmo_search(fj, key, *j_box, num=num, chunk=chunk)
    print(f"A port search, port objective    best f {float(f_a):.10g}")
    print(f"B port search, gp_tpu objective  best f {float(f_b):.10g}")
    print(f"C gp_tpu mvmo_search_hosted      best f {float(f_c):.10g} "
          f"(traced step for step: {float(arch_c[-1][1].min()):.10g})")
    print(f"D gp_tpu mvmo_search (one scan)  best f {float(f_d):.10g}")
    for name, log in (("A", fa), ("B", fb)):
        print(f"{name} vs C parting: "
              f"{parting(port_archives(log), arch_c, width, tol)}")

    rmse = lambda mu: float(np.sqrt(np.mean((np.asarray(mu) - yte) ** 2)))
    const = rmse(np.full_like(yte, ytr.mean()))
    gt2 = GP(Xtr, ytr, device="cpu", dtype=dname)
    gt2.draws = draws()
    gt2._multistart_chunk = gj._multistart_chunk = lambda: chunk
    nll_t = gt2.train(start)
    nll_j = gj.train(start)
    print(f"train(start): port NLL {nll_t:.10g} RMSE "
          f"{rmse(gt2.batch_predict(Xte)[0]):.6g} (search best f "
          f"{gt2.last_search[0]:.10g}); gp_tpu NLL {nll_j:.10g} RMSE "
          f"{rmse(gj.batch_predict(Xte)[0]):.6g}; constant {const:.6g}")


if __name__ == "__main__":
    main()
