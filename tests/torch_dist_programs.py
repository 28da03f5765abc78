"""The per-process programs of tests/test_torch_parallel.py.

Each runs in a process that parallel.mesh.spawn starts (gloo on the CPU),
so it lives in a module that imports neither jax nor gp_tpu: the
processes import it by name.  Every function returns numpy arrays and
Python scalars, compared in the test's process with gp_tpu.
"""

import os
import time

import numpy as np
import torch

from gp_tpu_torch.ops.kernels import SE_ARD
from gp_tpu_torch.parallel import pchol, pgp, pmultistart, psparse
from gp_tpu_torch.parallel.mesh import make_mesh_2d

BLOCK = 16


class FixedDraws:
    """A draw source handing out given uniform draws (gp_tpu's)."""

    def __init__(self, u):
        self.u = [np.asarray(a) for a in u]

    def uniform(self, shape, dtype, device):
        a = self.u.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.tensor(a, dtype=dtype, device=device)


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _n(t):
    return t.detach().cpu().numpy()


def quadratic_vg(v):
    """A test objective for the multi-start: a narrow basin at 2.2 in a
    field of cosine wells (tests/test_torch_multistart.py's)."""
    v = v.detach().requires_grad_(True)
    with torch.enable_grad():
        f = (torch.sum((v - 2.2) ** 2) * 0.05
             + torch.sum(1.0 - torch.cos(2.5 * (v - 2.2))))
        g, = torch.autograd.grad(f, v)
    return f.detach(), g


def world(mesh, prob):
    """Every distributed function of the port on one mesh; values from
    this process (replicated ones must agree across processes)."""
    ax = mesh.axis("rows")
    X, y, Xd, yd = (_t(prob[k]) for k in ("X", "y", "Xd", "yd"))
    hyp, xs = _t(prob["hyp"]), _t(prob["xs"])
    out = {"rank": ax.index}

    f, g = pgp.pnll_vg(SE_ARD, hyp, X, y, mesh, block=BLOCK)
    out["pnll"] = (float(f), _n(g))

    # the posterior at hyp (no rescue), its factor and K^-1 rows
    h, L, a, ok = pgp.pset_k(SE_ARD, hyp, X, y, mesh, block=BLOCK)
    out["pset_k"] = (_n(h), _n(pchol._all_gather(L, ax)), _n(a), ok)
    W = pchol.pinv_rows_local(L, ax.size, ax)
    out["W"] = _n(pchol.all_gather_rows(W, ax))
    kinv = torch.stack([pchol.pkinv_rowblock_local(W, l, ax.size, ax)
                        for l in range(W.shape[0])])
    out["kinv"] = _n(pchol.all_gather_rows(kinv, ax))
    out["kinv_full"] = _n(pchol.all_gather_rows(
        pchol.pinv_from_chol_local(L, ax.size, ax), ax))
    mu, s2 = pgp.ppredict(SE_ARD, h, X, L, a, xs, mesh)
    out["ppredict"] = (_n(mu), _n(s2))
    out["ppredict_with_grad"] = tuple(
        _n(t) for t in pgp.ppredict_with_grad(SE_ARD, h, X, L, a, xs, mesh))

    # the sqrt(10) rescue on duplicated rows
    hd, Ld, ad, okd = pgp.pset_k(SE_ARD, _t(prob["hyp_dup"]), Xd, yd, mesh,
                                 block=BLOCK)
    out["pset_k_rescue"] = (_n(hd), _n(ad), okd)

    # FITC and VFE, rows sharded
    U, jit = _t(prob["U"]), prob["jitter"]
    for model in ("fitc", "vfe"):
        fs, gs = psparse.pnll_sparse_vg(model, SE_ARD, hyp, X, y, U, jit,
                                        mesh)
        post = psparse.pset_k_sparse(model, SE_ARD, hyp, X, y, U, jit, mesh)
        rescue = psparse.pset_k_sparse(model, SE_ARD, hyp, X, y,
                                       _t(prob["U_dup"]),
                                       prob["jitter_sparse"], mesh)
        out[model] = (float(psparse.pnll_sparse(model, SE_ARD, hyp, X, y, U,
                                                jit, mesh)),
                      float(fs), _n(gs),
                      tuple(_n(t) if isinstance(t, torch.Tensor) else t
                            for t in post),
                      (float(rescue[3]), rescue[4]))

    # restarts spread over the processes
    lb, ub = _t(prob["ms_lb"]), _t(prob["ms_ub"])
    res = pmultistart.pmultistart_lbfgsb(
        quadratic_vg, FixedDraws([prob["ms_draws"]]), lb, ub,
        _t(prob["ms_x0"]), mesh, axis_name="rows",
        n_starts=prob["ms_n"], max_evals=60)
    out["pmultistart"] = (_n(res.x), float(res.f), _n(res.all_f),
                          _n(res.all_x))
    return out


def train(mesh, prob, path, gp_tpu_path):
    """GP.train_distributed from a fixed start, save_model / load_model /
    restore_distributed, and a gp_tpu file restored here."""
    from gp_tpu_torch import GP
    from gp_tpu_torch.utils.checkpoint import load_model
    xs = prob["xs"]
    gp = GP(prob["X"], prob["y"], device="cpu")
    f = gp.train_distributed(mesh, block=BLOCK, init_hyps=prob["hyp"])
    pred = (*(_n(t) for t in gp.batch_predict(xs)),
            *(_n(t) for t in gp.batch_predict_s2_with_grad(xs)),
            *(_n(t) for t in gp.batch_predict_y_with_grad(xs)))
    gp.save(path)
    torch.distributed.barrier()
    r = load_model(path, device="cpu")
    pending = True
    try:
        r.batch_predict(xs)
        pending = False
    except RuntimeError:
        pass
    r.restore_distributed(mesh)
    reloaded = tuple(_n(t) for t in r.batch_predict(xs))
    out = {"f": f, "hyp": gp.get_hyp(), "evals": int(gp.last_opt_result.evals),
           "pred": pred, "reloaded": reloaded, "pending": pending}
    if gp_tpu_path is not None:
        # the test's process writes it while these run
        deadline = time.monotonic() + 100
        while not os.path.exists(gp_tpu_path) and time.monotonic() < deadline:
            time.sleep(0.1)
        j = load_model(gp_tpu_path, device="cpu")
        j.restore_distributed(mesh)
        out["gp_tpu_file"] = tuple(_n(t) for t in j.batch_predict(xs))
    # FITC with the rows sharded, and the single-process FITC's NLL at
    # its hyps
    from gp_tpu_torch import FITC
    fitc, single = (FITC(prob["X"], prob["y"], device="cpu")
                    for _ in range(2))
    for m in (fitc, single):
        m.set_inducing(prob["U"])
    nll = fitc.train_distributed(mesh)
    single._jitter_u = fitc._jitter_u
    out["fitc"] = (nll, single.nll(fitc.get_hyp()),
                   int(fitc.last_opt_result.evals))
    # the 2-D multi-start: (starts, rows) = (2, P / 2)
    m2 = make_mesh_2d(2, mesh.shape["rows"] // 2)
    vec0s = np.stack([prob["ms_vec0"], prob["ms_vec0"] + 0.3])
    xb, fb = pgp.pfit_multistart(SE_ARD, False, _t(prob["X"]),
                                 _t(prob["ys"]), vec0s, _t(prob["lb"]),
                                 _t(prob["ub"]), m2, block=BLOCK)
    out["pfit_multistart"] = (_n(xb), float(fb))
    return out


def run(mesh, prob, path, gp_tpu_path):
    return {"world": world(mesh, prob),
            "train": train(mesh, prob, path, gp_tpu_path)}


def fail_on_rank_1(mesh):
    if mesh.axis("rows").index == 1:
        raise ValueError("rank 1 fails on purpose")
    return 0


def nccl_objective(mesh):
    """pnll_vg on the mesh and exact.nll_vg_raw on this process's card,
    float64, and the distributed evaluation's K2 launches."""
    import math
    from gp_tpu_torch.models import exact
    from gp_tpu_torch.ops import se_tile
    g = torch.Generator().manual_seed(9)
    n, d = 700, 5
    X = (torch.rand(n, d, generator=g, dtype=torch.float64) * 4 - 2).to(
        mesh.device)
    y = torch.sin(2 * X[:, 0]) + 0.1 * torch.randn(
        n, generator=g, dtype=torch.float64).to(mesh.device)
    hyp = torch.tensor([0.2] * d + [0.0, math.log(0.1), 0.0],
                       dtype=torch.float64, device=mesh.device)
    se_tile.reset_launches()
    f, gr = pgp.pnll_vg(SE_ARD, hyp, X, y, mesh, block=256)
    launches = se_tile.launches["se_matrix"]["se"]
    f1, g1 = exact.nll_vg_raw(SE_ARD, hyp, X, y)
    return float(f), _n(gr), float(f1), _n(g1), launches
