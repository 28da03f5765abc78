"""The per-process programs of tests/test_torch_pchol2d.py.

Each runs in a process that parallel.mesh.spawn starts (gloo on the CPU)
and builds its ("rowg", "colg") grid itself, so it lives in a module that
imports neither jax nor gp_tpu.  Every function returns numpy arrays and
Python scalars, compared in the test's process with gp_tpu.
"""

import os
import time

import numpy as np
import torch

from gp_tpu_torch.ops.kernels import SE_ARD
from gp_tpu_torch.parallel import multihost, pchol2d, pgp
from gp_tpu_torch.parallel.mesh import make_mesh_grid

BLOCK = 8
# the grid of a world of P processes
GRIDS = {4: (2, 2), 2: (1, 2)}


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _n(t):
    return t.detach().cpu().numpy()


def _wait(path, seconds=150):
    """The test's process writes gp_tpu's files while these run."""
    deadline = time.monotonic() + seconds
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.1)


def _tiles(L):
    return np.ascontiguousarray(_n(L))


def grid_values(m, prob):
    """The grid functions at prob's hyps; this process's tiles."""
    g = pchol2d.grid_of(m)
    X, y, Xd, yd = (_t(prob[k]) for k in ("X", "y", "Xd", "yd"))
    hyp, xs = _t(prob["hyp"]), _t(prob["xs"])
    out = {"rc": (g.r, g.c)}

    f, gr = pchol2d.pnll_vg2d(SE_ARD, hyp, X, y, m, block=BLOCK)
    out["pnll_vg2d"] = (float(f), _n(gr))
    out["pnll2d"] = float(pchol2d.pnll2d(SE_ARD, hyp, X, y, m, block=BLOCK))
    out["pnll2d_bad"] = float(pchol2d.pnll2d(SE_ARD, _t(prob["hyp_bad"]), X,
                                             y, m, block=BLOCK))

    h, L, a, ok = pchol2d.pset_k2d(SE_ARD, hyp, X, y, m, block=BLOCK)
    W = pchol2d.pinv2d_local(L, g)
    out["pset_k2d"] = (_n(h), _tiles(L), _n(a), ok)
    out["W"] = _tiles(W)
    out["kinv"] = _tiles(pchol2d.pkinv2d_local(W, g))
    out["ppredict2d"] = tuple(
        _n(t) for t in pchol2d.ppredict2d(SE_ARD, h, X, L, a, xs, m))
    out["ppredict2d_with_grad"] = tuple(
        _n(t) for t in pchol2d.ppredict2d_with_grad(SE_ARD, h, X, L, a, xs,
                                                    m))

    # the look-ahead against the sequential schedule, on K at hyp
    x_pad, _, n = pchol2d._pad_xy(X, y, g, BLOCK)
    K, _, _ = pchol2d._build_k_local(SE_ARD, hyp, x_pad, n, g, BLOCK)
    Ls = [pchol2d.pchol2d_local(pchol2d.tiles(pchol2d.flat(K).clone(),
                                              BLOCK), g, lookahead=la)
          for la in (True, False)]
    out["lookahead_bitwise"] = torch.equal(Ls[0], Ls[1])

    hd, _, ad, okd = pchol2d.pset_k2d(SE_ARD, _t(prob["hyp_dup"]), Xd, yd, m,
                                      block=BLOCK)
    out["pset_k2d_rescue"] = (_n(hd), _n(ad), okd)
    return out


def _pred(gp, xs):
    return (*(_n(t) for t in gp.batch_predict(xs)),
            *(_n(t) for t in gp.batch_predict_s2_with_grad(xs)),
            *(_n(t) for t in gp.batch_predict_y_with_grad(xs)))


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def models(mesh, m, prob, paths):
    """GP.train_distributed on the grid from a fixed start, the
    checkpoints in both layouts, and gp_tpu's files read here."""
    from gp_tpu_torch import GP
    from gp_tpu_torch.utils.checkpoint import (load_model,
                                               load_model_sharded,
                                               save_model_sharded)
    P = mesh.shape["rows"]
    xs = prob["xs"]
    out = {}
    gp = GP(prob["X"], prob["y"], device="cpu")
    f = gp.train_distributed(m, block=BLOCK, init_hyps=prob["hyp"])
    pred = _pred(gp, xs)
    out["train"] = {"f": f, "hyp": gp.get_hyp(), "pred": pred}

    # save_model -> load_model -> restore_distributed, and the sharded
    # round trip, on the grid
    gp.save(paths["port_file"])
    torch.distributed.barrier()
    r = load_model(paths["port_file"], device="cpu")
    try:
        r.batch_predict(xs)
        pending = False
    except RuntimeError:
        pending = True
    r.restore_distributed(m)
    out["reloaded"] = _pred(r, xs)
    out["pending"] = pending
    save_model_sharded(gp, paths["port_sharded_grid"])
    s = load_model_sharded(paths["port_sharded_grid"], m, device="cpu")
    out["sharded_grid"] = _pred(s, xs)

    # the same on the 1-D mesh of all P processes, at prob's hyps
    g1 = GP(prob["X"], prob["y"], device="cpu")
    h, L, a, ok = pgp.pset_k(SE_ARD, _t(prob["hyp"]), _t(prob["X"]),
                             _t(prob["y"]), mesh, block=BLOCK)
    g1._hyps, g1._post_dist, g1._trained = h, (mesh, BLOCK, L, a), True
    save_model_sharded(g1, paths["port_sharded_rows"])
    s1 = load_model_sharded(paths["port_sharded_rows"], mesh, device="cpu")
    out["sharded_rows"] = (_pred(g1, xs), _pred(s1, xs))

    # a layout that is not the checkpoint's: a 1-D mesh for a grid file,
    # the transposed grid (or another shape), a grid for a 1-D file
    pr, pc = GRIDS[P]
    other = make_mesh_grid(pc, pr) if pr != pc else make_mesh_grid(1, P)
    out["mismatch"] = {
        "restore_1d": _raises(lambda: load_model(
            paths["port_file"], device="cpu").restore_distributed(mesh)),
        "restore_other": _raises(lambda: load_model(
            paths["port_file"], device="cpu").restore_distributed(other)),
        "sharded_1d": _raises(lambda: load_model_sharded(
            paths["port_sharded_grid"], mesh, device="cpu")),
        "sharded_other": _raises(lambda: load_model_sharded(
            paths["port_sharded_grid"], other, device="cpu")),
        "sharded_rows_on_grid": _raises(lambda: load_model_sharded(
            paths["port_sharded_rows"], m, device="cpu")),
    }

    # multihost's meshes: two "hosts" of P / 2 processes
    os.environ["LOCAL_WORLD_SIZE"] = str(P // 2)
    mh = multihost.global_mesh_2d()
    out["multihost"] = (multihost.is_multiprocess(),
                        (mh.shape["rowg"], mh.shape["colg"]),
                        multihost.global_mesh().shape["rows"])

    # gp_tpu's files, written by the test's process meanwhile
    if P == 4:
        _wait(paths["gp_tpu_file"])
        j = load_model(paths["gp_tpu_file"], device="cpu")
        j.restore_distributed(m)
        out["gp_tpu_file"] = tuple(_n(t) for t in j.batch_predict(xs))
        _wait(paths["gp_tpu_sharded_grid"])
        j = load_model_sharded(paths["gp_tpu_sharded_grid"], m,
                               device="cpu")
        out["gp_tpu_sharded_grid"] = tuple(_n(t)
                                           for t in j.batch_predict(xs))
    else:
        _wait(paths["gp_tpu_sharded_rows"])
        j = load_model_sharded(paths["gp_tpu_sharded_rows"], mesh,
                               device="cpu")
        out["gp_tpu_sharded_rows"] = tuple(_n(t)
                                           for t in j.batch_predict(xs))
    return out


def run(mesh, prob, paths):
    m = make_mesh_grid(*GRIDS[mesh.shape["rows"]])
    return {"grid": grid_values(m, prob), "models": models(mesh, m, prob,
                                                           paths)}


def nccl_pchol2d(mesh, n: int, block: int):
    """pchol2d_local on a (1, 1) NCCL grid against the library Cholesky on
    this process's card, float32 and float64: max |L - L_lib| / max
    |L_lib| by dtype; and a grid NLL+gradient's K2 launches."""
    from gp_tpu_torch.ops import se_tile
    m = make_mesh_grid(1, 1)
    g = pchol2d.grid_of(m)
    gen = torch.Generator().manual_seed(5)
    A = torch.randn(n, n, generator=gen, dtype=torch.float64)
    K64 = (A @ A.T / n + torch.eye(n, dtype=torch.float64)).to(m.device)
    err = {}
    for dt in (torch.float32, torch.float64):
        K = K64.to(dt)
        L = pchol2d.flat(pchol2d.pchol2d_local(
            pchol2d.tiles(K.clone(), block), g)).tril()
        L0 = torch.linalg.cholesky(K)
        err[str(dt)] = float((L - L0).abs().max() / L0.abs().max())
    X = torch.rand(300, 4, generator=gen, dtype=torch.float64).to(m.device)
    y = torch.sin(3 * X[:, 0])
    hyp = torch.tensor([0.0] * 4 + [0.0, -2.0, 0.0], dtype=torch.float64,
                       device=m.device)
    se_tile.reset_launches()
    pchol2d.pnll_vg2d(SE_ARD, hyp, X, y, m, block=64)
    return err, se_tile.launches["se_matrix"]["se"]
