"""Model checkpoint / resume in gp_tpu's file format (counterpart of
gp_tpu/utils/checkpoint.py:24-176).

A fitted model (training data, hyperparameters and the posterior cache:
the Cholesky factors and alpha) is written to one ``.npz``, so that a
prediction service resumes without refactorizing.  The format is
gp_tpu's: numpy savez with a ``meta`` json string (format_version, model,
kernel, solver, dtype by name, noise_lb, noise_free, fixhyps, trained,
num_post, bucket, jitter_u) and the arrays x, y, hyps, inducing, post_<i>
and key.  Each package loads the other's files:

  * the posterior tuples are gp_tpu's: GP (L, invKys), with a QR solver
    (Q, R, invKys) or, pivoted, (Q, R, perm, invKys); BucketedGP
    (blockdiag(L, I), invKys zero-padded) at its capacity; FITC and VFE
    (Luu, LA, alpha);
  * `key` is a valid jax.random key, [seed >> 32, seed & 0xffffffff] of
    the model's seed (jax.random.PRNGKey(seed)), because gp_tpu's
    load_model reads it; the port keeps its own search generator's state
    under `draws_state`, which gp_tpu ignores.  The search's draws do not
    carry across the two packages: a port model loaded from a gp_tpu file
    draws from a generator seeded with key's value, a gp_tpu model loaded
    from a port file from jax.random with that key.

A stream-regime GP (N >= 32768) caches no factor: its posterior is
(invKys,) and meta's `post_aux` holds the scalars (logdet, refined NLL),
as gp_tpu writes them (checkpoint.py:100-105, 152); its variance
predictions refactor after a load.

A distributed posterior is gathered to the mesh's first process in
gp_tpu's layout and meta (checkpoint.py:37-80): dist_L as (nbl, P, B,
N_pad) with dist_n_dev from a 1-D "rows" mesh (parallel/pgp.py), as
(Pr, Pc, nbr, nbc, B, B) with dist_grid = [Pr, Pc] from a ("rowg",
"colg") grid (parallel/pchol2d.py), and dist_invKys, dist_block.
load_model leaves it pending until `model.restore_distributed(mesh)` on
a mesh of the same layout (checkpoint.py:150-158).

The sharded checkpoint (save_model_sharded / load_model_sharded, gp_tpu's
format "gp_tpu-sharded-v1", checkpoint.py:179-339) writes no gather: a
directory with meta.npz (process 0: meta, x, y, hyps, invKys, key) and
one shards_p{rank}.npz a process (data_i, start_i, stop_i: its block of
L and the block's index bounds in gp_tpu's global shape, sliced on axis
1 of (nbl, P, B, N_pad) or axes 0 and 1 of (Pr, Pc, nbr, nbc, B, B)).
A gp_tpu job writes all of its devices' shards into shards_p0.npz, so
the loader finds its block by its bounds in whichever file holds it; npz
members load lazily, so a process decompresses only its own block's
data.
"""

from __future__ import annotations

import json
import warnings

import numpy as np
import torch

from ..models.base import _np
from ..optim.multistart import GeneratorDraws
from .convert import model_from_state

_FORMAT_VERSION = 1


def _key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed)'s value."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def _post_tensor(a: np.ndarray, model):
    """A posterior array on the model's device: in its dtype, or int64 for
    an integer array (qr_pivot's perm; gp_tpu's load_model casts that to
    the model's dtype too)."""
    t = torch.from_numpy(a)
    if t.is_floating_point():
        return t.to(device=model.device, dtype=model.dtype)
    return t.to(device=model.device, dtype=torch.int64)


def _layout(mesh) -> dict:
    """gp_tpu's layout record of a distributed posterior's mesh:
    {"grid": [Pr, Pc]} or {"n_dev": P}."""
    if {"rowg", "colg"} <= set(mesh.axis_names):
        return {"grid": [mesh.shape["rowg"], mesh.shape["colg"]]}
    from ..parallel.pgp import AXIS
    return {"n_dev": mesh.shape[AXIS]}


def _gather_dist(model):
    """(L in gp_tpu's global layout, (nbl, P, B, N_pad) or (Pr, Pc, nbr,
    nbc, B, B), invKys) of a distributed posterior, gathered to the
    mesh's first process (None elsewhere)."""
    import torch.distributed as dist
    mesh, _, L, invKys = model._post_dist
    grid = "grid" in _layout(mesh)
    ax = mesh.whole if grid else mesh.axis("rows")
    parts = ([torch.empty(L.shape, dtype=L.dtype, device=L.device)
              for _ in range(ax.size)] if ax.index == 0 else None)
    dist.gather(L.contiguous(), parts, dst=ax.ranks[0], group=ax.group)
    if ax.index:
        return None
    if grid:
        Lg = torch.stack(parts).reshape(mesh.shape["rowg"],
                                        mesh.shape["colg"], *L.shape)
    else:
        Lg = torch.stack(parts, dim=1)
    return _np(Lg), _np(invKys)


def save_model(model, path: str) -> None:
    """Serialize a (possibly trained) model to `path` (.npz).  A
    distributed posterior is gathered in gp_tpu's layout (dist_L,
    dist_invKys; meta dist_n_dev or dist_grid, dist_block): every process
    of its mesh calls save_model, and the mesh's first process writes the
    file."""
    trained = model._trained
    dist_post = model._post_dist
    gathered = None
    if trained and dist_post is not None:
        gathered = _gather_dist(model)
        if gathered is None:
            return
    if trained and model._post is None and dist_post is None:
        warnings.warn("trained model has no posterior cache; the "
                      "checkpoint stores hyperparameters only: refit or "
                      "recompute the posterior after loading")
        trained = False
    arrays = {"x": _np(model._x), "y": _np(model._y)}
    meta = {
        "format_version": _FORMAT_VERSION,
        "model": type(model).__name__,
        "kernel": model.kernel.name,
        "solver": model.solver.name,
        "dtype": str(model._dtype).rsplit(".", 1)[-1],
        "noise_lb": model._noise_lb,
        "noise_free": model._noise_free,
        "fixhyps": model._fixhyps,
        "trained": trained,
    }
    if hasattr(model, "_bucket"):
        meta["bucket"] = int(model._bucket)
    if model._hyps is not None:
        arrays["hyps"] = _np(model._hyps)
    if hasattr(model, "_u"):
        arrays["inducing"] = _np(model._u)
        meta["jitter_u"] = float(model._jitter_u)
    if gathered is not None:
        arrays["dist_L"], arrays["dist_invKys"] = gathered
        meta.update({f"dist_{k}": v
                     for k, v in _layout(dist_post[0]).items()})
        meta["dist_block"] = int(dist_post[1])
    if trained and model._post is not None:
        for i, a in enumerate(model._post):
            arrays[f"post_{i}"] = _np(a)
        meta["num_post"] = len(model._post)
    if model._post_aux is not None:
        meta["post_aux"] = model._post_aux
    arrays["key"] = _key(model._seed)
    if isinstance(model.draws, GeneratorDraws):
        arrays["draws_state"] = model.draws.gen.get_state().numpy()
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def _model(meta: dict, z, device):
    """The model that meta and the arrays z (x, y, key, hyps, inducing,
    draws_state) describe, without its posterior."""
    key = z["key"].astype(np.uint64)
    state = {"model": meta["model"], "x": z["x"], "y": z["y"],
             "kernel": meta["kernel"], "dtype": meta["dtype"],
             "solver": meta.get("solver", "chol"),
             "noise_free": meta["noise_free"],
             "noise_lb": meta["noise_lb"],
             "seed": int(key[0]) << 32 | int(key[1])}
    for k in ("bucket", "jitter_u"):
        if k in meta:
            state[k] = meta[k]
    for k in ("hyps", "inducing"):
        if k in z:
            state[k] = z[k]
    model = model_from_state(state, device)
    model._fixhyps = meta["fixhyps"]
    if "draws_state" in z:
        model.draws.gen.set_state(torch.from_numpy(z["draws_state"]))
    return model


def load_model(path: str, device=None):
    """The model saved by `save_model`, of either package, with its
    posterior cache intact: no refactorization.  On CUDA unless `device`
    says otherwise, in the dtype the file names."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["format_version"] > _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {meta['format_version']} is newer than "
                f"this library ({_FORMAT_VERSION})")
        model = _model(meta, z, device)
        if meta["trained"] and "num_post" in meta:
            model._post = tuple(_post_tensor(z[f"post_{i}"], model)
                                for i in range(meta["num_post"]))
            model._trained = True
        model._post_aux = meta.get("post_aux")
        if meta["trained"] and ("dist_n_dev" in meta or "dist_grid" in meta):
            # attached by restore_distributed(mesh) on every process
            layout = (tuple(meta["dist_grid"]) if "dist_grid" in meta
                      else meta["dist_n_dev"])
            model._post_dist_pending = (layout, meta["dist_block"],
                                        z["dist_L"], z["dist_invKys"])
            model._trained = True
    return model


_SHARDED = "gp_tpu-sharded-v1"


def _block_bounds(mesh, local: tuple):
    """(this process's rank on the mesh, gp_tpu's global shape of L, and
    the index bounds of this process's block in it), from the shape of
    its local L: (nbr, nbc, B, B) on a grid, (nbl, B, N_pad) on "rows"."""
    if "grid" in _layout(mesh):
        from ..parallel.pchol2d import grid_of
        g = grid_of(mesh)
        return (mesh.whole.index, (g.pr, g.pc, *local),
                [g.r, g.c, 0, 0, 0, 0], [g.r + 1, g.c + 1, *local])
    ax = mesh.axis("rows")
    nbl, B, n_pad = local
    return (ax.index, (nbl, ax.size, B, n_pad), [0, ax.index, 0, 0],
            [nbl, ax.index + 1, B, n_pad])


def save_model_sharded(model, dirpath: str) -> None:
    """Checkpoint a GP's distributed posterior without a gather, in
    gp_tpu's sharded format (the module docstring): each process writes
    shards_p{rank}.npz with its own block of L, process 0 writes
    meta.npz.  Every process of the mesh calls it; it returns when every
    process has written (a barrier over the mesh).  Restore with
    `load_model_sharded(dirpath, mesh)` on a mesh of the same layout."""
    import os

    import torch.distributed as dist
    if model._post_dist is None:
        raise ValueError(
            "save_model_sharded needs a live distributed posterior "
            "(train_distributed or load_model_sharded); use save_model for "
            "single-device models")
    if type(model).__name__ != "GP":
        raise ValueError(
            "sharded checkpoints cover the exact GP's distributed "
            "posterior (the only N^2-scale factor); use save_model")
    mesh, block, L, invKys = model._post_dist
    rank, shape, start, stop = _block_bounds(mesh, tuple(L.shape))
    data = _np(L)[None, None] if len(shape) == 6 else _np(L)[:, None]
    os.makedirs(dirpath, exist_ok=True)
    np.savez_compressed(os.path.join(dirpath, f"shards_p{rank}.npz"),
                        data_0=data, start_0=np.asarray(start, np.int64),
                        stop_0=np.asarray(stop, np.int64))
    if rank == 0:
        meta = {"format": _SHARDED, "model": type(model).__name__,
                "kernel": model.kernel.name, "solver": model.solver.name,
                "dtype": str(model._dtype).rsplit(".", 1)[-1],
                "noise_lb": model._noise_lb,
                "noise_free": model._noise_free,
                "fixhyps": model._fixhyps, "block": int(block),
                "L_shape": [int(v) for v in shape], **_layout(mesh)}
        arrays = {"x": _np(model._x), "y": _np(model._y),
                  "hyps": _np(model._hyps), "invKys": _np(invKys),
                  "key": _key(model._seed)}
        if isinstance(model.draws, GeneratorDraws):
            arrays["draws_state"] = model.draws.gen.get_state().numpy()
        np.savez_compressed(os.path.join(dirpath, "meta.npz"),
                            meta=json.dumps(meta), **arrays)
    ax = mesh.whole if len(shape) == 6 else mesh.axis("rows")
    dist.barrier(group=ax.group)


def _find_block(dirpath: str, start: list, stop: list):
    """The block with these index bounds, from whichever shards_p*.npz
    holds it; only its data_i is decompressed."""
    import glob
    import os
    for path in sorted(glob.glob(os.path.join(dirpath, "shards_p*.npz"))):
        with np.load(path, allow_pickle=False) as z:
            for k in z.files:
                if not k.startswith("start_"):
                    continue
                i = k[len("start_"):]
                if (z[k].tolist() == start
                        and z[f"stop_{i}"].tolist() == stop):
                    return z[f"data_{i}"]
    raise ValueError(f"no shard {start}:{stop} in {dirpath}")


def load_model_sharded(dirpath: str, mesh, device=None):
    """The GP and its distributed posterior from a sharded checkpoint of
    either package, each process reading only its own block.  `mesh`
    must have the checkpoint's layout (a "rows" axis of its process
    count, or a ("rowg", "colg") grid of its shape), else ValueError; on
    CUDA unless `device` says otherwise."""
    import os
    with np.load(os.path.join(dirpath, "meta.npz"),
                 allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("format") != _SHARDED:
            raise ValueError(f"not a sharded checkpoint: "
                             f"{meta.get('format')}")
        arrays = {k: z[k] for k in z.files if k != "meta"}
    grid = "grid" in meta
    got = _layout(mesh) if ({"rowg", "colg"} <= set(mesh.axis_names)
                            or "rows" in mesh.axis_names) else {}
    if got != {k: meta[k] for k in ("grid", "n_dev") if k in meta}:
        what = (f"a {tuple(meta['grid'])} ('rowg', 'colg') grid" if grid
                else f"{meta['n_dev']} devices on axis 'rows'")
        raise ValueError(f"checkpoint is blocked for {what}; mesh has axes "
                         f"{mesh.axis_names} shape {dict(mesh.shape)}")
    shape = tuple(meta["L_shape"])
    _, _, start, stop = _block_bounds(
        mesh, shape[2:] if grid else (shape[0], *shape[2:]))
    data = _find_block(dirpath, start, stop)
    if grid:
        from ..parallel.pchol2d import local_tiles
        L = local_tiles(data, 0, 0)
    else:
        L = torch.from_numpy(np.ascontiguousarray(data[:, 0]))
    model = _model(meta, arrays, device)
    model._post_dist = (mesh, meta["block"], model._tensor(L),
                        model._tensor(arrays["invKys"]))
    model._trained = True
    return model
