"""Global hyperparameter search (counterpart of gp_tpu/optim/multistart.py).

The reference's MVMO global restart (GP.cpp:463-485, select_init_hyp) and
gp_tpu's multi-start L-BFGS-B: candidates in the bound box are scored by
the caller's objective, in chunks, and the best finite one wins; when
nothing is finite the caller's default point comes back (GP.cpp:484).

Objective contract.  `fun` maps a batch of candidates (c, n) to their
values (c,), +inf for a rejected or non-SPD candidate (the models install
the sn2 > mean(sf2) rejection, GP.cpp:470-471).  gp_tpu vmaps a
one-candidate function over each chunk; here a chunk is handed over as
one (c, n) tensor and the models evaluate its rows one by one (one batched
factor of a chunk paid off on the card only at N = 1024 and lost 2.2x at
4096: scripts/search_batch_timing.py).  The chunk bounds memory; it never
changes a value.

Randomness.  gp_tpu draws from jax.random keys.  Here every sampler takes
a draw source with two methods,

    draws.uniform(shape, dtype, device)  -> U[0, 1) values
    draws.bernoulli(p, shape, device)    -> bool, True with probability p

and asks for its draws in the order gp_tpu splits its key: `sample_box`
one uniform (num, n); `mvmo_search` the archive's uniform (archive - 1, n),
then per generation a uniform (chunk, n) and a Bernoulli (chunk, n)
(multistart.py:34, 109-114, 177-188).  `GeneratorDraws` is the default: an
explicit torch.Generator seeded by the caller, no global RNG state.  A
source that replays gp_tpu's draws makes the two searches agree draw for
draw (tests/test_torch_multistart.py).

Not carried: `mvmo_search_hosted` and `multistart_lbfgsb_hosted`.  They
exist to keep each device execution of gp_tpu's TPU runtime under its
execution watchdog; the port's searches are host-driven loops already, and
no watchdog stands over a CUDA launch.  A batched L-BFGS-B across the
starts is later work (ROADMAP): the starts run one after another.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import INF
from .lbfgsb import lbfgsb_impl

# width of the sampling window that replaces an infinite bound
SPAN = 80.0


class GeneratorDraws:
    """Draws from an explicit CPU torch.Generator seeded with `seed`,
    moved to the caller's device: the same values on every device."""

    def __init__(self, seed: int):
        self.gen = torch.Generator().manual_seed(int(seed))

    def uniform(self, shape, dtype, device):
        return torch.rand(shape, generator=self.gen, dtype=dtype).to(device)

    def bernoulli(self, p: float, shape, device):
        return (torch.rand(shape, generator=self.gen, dtype=torch.float32)
                < p).to(device)


def _inf_if_not_finite(v):
    return torch.where(torch.isfinite(v), v, torch.full_like(v, INF))


def _box(lb, ub):
    """(lower corner, width) of the finite sampling box: an infinite bound
    is replaced by an 80-wide window."""
    lb_f = torch.where(torch.isfinite(lb), lb,
                       torch.where(torch.isfinite(ub), ub - SPAN,
                                   torch.full_like(lb, -SPAN)))
    ub_f = torch.where(torch.isfinite(ub), ub, lb_f + SPAN)
    return lb_f, ub_f - lb_f


def _like(t, ref):
    return torch.as_tensor(t).to(device=ref.device, dtype=ref.dtype)


def sample_box(draws, lb, ub, num: int, dtype=None, device=None):
    """Uniform candidates (num, n) in [lb, ub]; infinite bounds are clamped
    to a finite window so sampling stays well-defined."""
    lb = torch.as_tensor(lb)
    dtype = lb.dtype if dtype is None else dtype
    device = lb.device if device is None else device
    lb = lb.to(device=device, dtype=dtype)
    lb_f, width = _box(lb, _like(ub, lb))
    u = draws.uniform((num, lb.shape[0]), dtype, device)
    return lb_f + u * width


def _evaluate(fun, cands, chunk: int):
    """fun over the rows of cands, `chunk` rows per call."""
    return torch.cat([fun(cands[i:i + chunk])
                      for i in range(0, cands.shape[0], chunk)])


def random_search(fun: Callable, draws, lb, ub, x_default, num: int = 1000,
                  chunk: int = 8):
    """Best of `num` uniform candidates; returns (best_x, best_f), best_x =
    x_default when nothing is finite.

    gp_tpu pads the last chunk with copies of the first candidate and sets
    their values to INF; here the last chunk is evaluated short, which
    gives the same values and the same argmin without the padding's
    evaluations."""
    x_default = torch.as_tensor(x_default)
    cands = sample_box(draws, lb, ub, num, x_default.dtype, x_default.device)
    vals = _evaluate(fun, cands, chunk)
    best = torch.argmin(vals)
    best_f = vals[best]
    if not bool(torch.isfinite(best_f)):
        return x_default, best_f
    return cands[best], best_f


def mvmo_search(fun: Callable, draws, lb, ub, x_default, num: int = 1000,
                chunk: int = 8, archive: int = 25, fs_init: float = 0.5,
                fs_final: float = 20.0):
    """Adaptive global search with MVMO semantics (Mean-Variance Mapping
    Optimization), as the reference configures it for select_init_hyp
    (GP.cpp:478-484: fs_init 0.5, fs_final 20, archive 25), in gp_tpu's
    form:

      * an elite archive of the `archive` best (z, f) pairs in the [0, 1]^n
        normalized box, seeded with the default point and uniform draws;
      * each generation's `chunk` children inherit the archive's best on a
        Bernoulli(0.5) subset of the variables and take the rest from the
        h-mapping h(u) = xbar (1 - e^{-u s}) + (1 - xbar) e^{-(1-u) s},
        centred on the finite archive's mean xbar with the shaping factor
        s = fs max(-log var, 1) from its variance;
      * fs ramps geometrically fs_init -> fs_final over the num // chunk
        generations;
      * children and archive merge, and the best `archive` stay (stable
        sorts: equal values, INF among them, keep their order).

    Returns (best_x, best_f), best_x = x_default when nothing is finite."""
    x_default = torch.as_tensor(x_default)
    dt, dev = x_default.dtype, x_default.device
    nv = x_default.shape[0]
    lb_f, width = _box(_like(lb, x_default), _like(ub, x_default))
    denorm = lambda z: lb_f + z * width
    n_gen = max(num // chunk, 1)

    z0 = torch.clamp((x_default - lb_f) / width, 0.0, 1.0)
    za = torch.cat([z0[None, :], draws.uniform((archive - 1, nv), dt, dev)])
    fa = _inf_if_not_finite(_evaluate(fun, denorm(za), chunk))

    for t in range(n_gen):
        frac = torch.tensor(t, dtype=dt, device=dev) / max(n_gen - 1, 1)
        fs = fs_init * (fs_final / fs_init) ** frac
        order = torch.argsort(fa, stable=True)
        za_s, fa_s = za[order], fa[order]
        finite = torch.isfinite(fa_s)[:, None]
        wsum = torch.clamp(torch.sum(finite), min=1)
        xbar = torch.sum(torch.where(finite, za_s, 0.0), dim=0) / wsum
        var = torch.sum(torch.where(finite, (za_s - xbar) ** 2, 0.0),
                        dim=0) / wsum
        s = fs * torch.clamp(-torch.log(torch.clamp(var, min=1e-12)),
                             min=1.0)

        u = draws.uniform((chunk, nv), dt, dev)
        h = (xbar[None, :] * (1.0 - torch.exp(-u * s[None, :]))
             + (1.0 - xbar[None, :]) * torch.exp(-(1.0 - u) * s[None, :]))
        # mutate a random subset of the variables; inherit the best
        # elsewhere
        sel = draws.bernoulli(0.5, (chunk, nv), dev)
        child = torch.clamp(torch.where(sel, h, za_s[0][None, :]), 0.0, 1.0)
        fc = _inf_if_not_finite(fun(denorm(child)))

        z_all = torch.cat([za_s, child])
        f_all = torch.cat([fa_s, fc])
        keep = torch.argsort(f_all, stable=True)[:archive]
        za, fa = z_all[keep], f_all[keep]

    best = torch.argmin(fa)
    best_f = fa[best]
    if not bool(torch.isfinite(best_f)):
        return x_default, best_f
    return denorm(za[best]), best_f


def mvmo_evaluations(num: int, chunk: int, archive: int = 25) -> int:
    """Objective evaluations of mvmo_search(num, chunk, archive): the
    archive's seed and num // chunk generations of `chunk` children."""
    return archive + max(num // chunk, 1) * chunk


class MultistartResult(NamedTuple):
    x: torch.Tensor          # best start's end point
    f: torch.Tensor          # its objective value
    all_f: torch.Tensor      # (n_starts,) every start's value, INF if not finite
    all_x: torch.Tensor      # (n_starts, n) every start's end point
    evals: list              # objective evaluations of each start


def multistart_lbfgsb(fun: Callable, draws, lb, ub, x0, n_starts: int = 8,
                      max_evals: int = 160) -> MultistartResult:
    """n_starts bounded L-BFGS runs from x0 and n_starts - 1 sample_box
    points, each through lbfgsb_impl; the best finite end point wins.

    gp_tpu vmaps lbfgsb_impl over the starts; under vmap each lane's result
    is its own run, so running them one after another gives the same
    values.  fun: x -> (f, g) over the optimization vector."""
    starts = sample_box(draws, lb, ub, n_starts - 1, x0.dtype, x0.device)
    starts = torch.cat([x0[None, :], starts])
    runs = [lbfgsb_impl(fun, s, lb, ub, max_evals=max_evals) for s in starts]
    all_f = _inf_if_not_finite(torch.stack([r.f for r in runs]))
    all_x = torch.stack([r.x for r in runs])
    best = int(torch.argmin(all_f))
    return MultistartResult(all_x[best], runs[best].f, all_f, all_x,
                            [int(r.evals) for r in runs])
