"""Multi-start hyperparameter fitting spread over a mesh axis (counterpart
of gp_tpu/parallel/pmultistart.py:30-70).

gp_tpu vmaps the restarts into one batched program and shards its batch
axis over the mesh axis, so that each device runs its slice of the
L-BFGS-B population and only the final (value, argmin) crosses devices.
Here every process draws all the starts from the same draw source (the
same seed gives the same draws in every process), runs its contiguous
slice of them one after another through lbfgsb_impl (as
optim.multistart.multistart_lbfgsb runs its starts), and one all-gather
gives every process the population's values and end points.

Not carried: the NamedSharding of the start batch (a process holds its own
slice).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import INF
from ..optim.lbfgsb import lbfgsb_impl
from ..optim.multistart import MultistartResult, sample_box
from .pchol import _all_gather


def best_of(x_loc, f_loc, axis):
    """(best x, its f, all f INF-sanitized, all x) of the axis' processes'
    (k, n) end points and (k,) values, gathered in rank order; the best is
    the first minimum of the sanitized values, as jnp.argmin takes it."""
    all_x = _all_gather(x_loc, axis).reshape(-1, x_loc.shape[-1])
    raw_f = _all_gather(f_loc, axis).reshape(-1)
    all_f = torch.where(torch.isfinite(raw_f), raw_f,
                        torch.full_like(raw_f, INF))
    best = int(torch.argmin(all_f))
    return all_x[best], raw_f[best], all_f, all_x


def pmultistart_lbfgsb(fun: Callable, draws, lb, ub, x0, mesh,
                       axis_name: str = "starts", n_starts: int | None = None,
                       max_evals: int = 160) -> MultistartResult:
    """n_starts bounded L-BFGS-B runs spread over the mesh axis axis_name:
    x0 and n_starts - 1 sample_box draws from `draws`, n_starts rounded up
    to a multiple of the axis' size (one start per process by default).
    fun: vec -> (f, g), INF-sanitized.  Every process of the axis calls it
    with the same draw source state; each returns the same result.  The
    `evals` field lists this process's runs only."""
    ax = mesh.axis(axis_name)
    n_dev = ax.size
    if n_starts is None:
        n_starts = n_dev
    n_starts = -(-n_starts // n_dev) * n_dev
    x0 = torch.as_tensor(x0)
    starts = torch.cat([x0[None, :], sample_box(draws, lb, ub, n_starts - 1,
                                                x0.dtype, x0.device)])
    k = n_starts // n_dev
    mine = starts[ax.index * k:(ax.index + 1) * k]
    runs = [lbfgsb_impl(fun, s, lb, ub, max_evals=max_evals) for s in mine]
    x, f, all_f, all_x = best_of(torch.stack([r.x for r in runs]),
                                 torch.stack([r.f for r in runs]), ax)
    return MultistartResult(x, f, all_f, all_x, [int(r.evals) for r in runs])
