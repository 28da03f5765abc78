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

A distributed posterior (parallel/pgp.py, a 1-D "rows" mesh) is gathered
to the mesh's first process in gp_tpu's layout and meta (dist_L as
(nbl, P, B, N_pad), dist_invKys, dist_n_dev, dist_block;
checkpoint.py:37-80); load_model leaves it pending until
`model.restore_distributed(mesh)` on a mesh of as many processes
(checkpoint.py:150-158).

Not carried: a 2-D grid posterior (dist_grid, gp_tpu's pchol2d) and the
sharded checkpoint (save_model_sharded / load_model_sharded,
checkpoint.py:179-339) are ROADMAP module 14, part 2; a file that holds a
grid posterior raises.
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


def _gather_dist(model):
    """(L (nbl, P, B, N_pad) in gp_tpu's global layout, invKys) of a
    distributed posterior, gathered to the mesh's first process (None
    elsewhere)."""
    import torch.distributed as dist
    from ..parallel.pgp import AXIS
    mesh, _, L, invKys = model._post_dist
    ax = mesh.axis(AXIS)
    parts = ([torch.empty_like(L) for _ in range(ax.size)]
             if ax.index == 0 else None)
    dist.gather(L.contiguous(), parts, dst=ax.ranks[0], group=ax.group)
    if ax.index:
        return None
    return _np(torch.stack(parts, dim=1)), _np(invKys)


def save_model(model, path: str) -> None:
    """Serialize a (possibly trained) model to `path` (.npz).  A
    distributed posterior is gathered in gp_tpu's layout (dist_L as
    (nbl, P, B, N_pad), dist_invKys; meta dist_n_dev, dist_block): every
    process of its mesh calls save_model, and the mesh's first process
    writes the file."""
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
        from ..parallel.pgp import AXIS
        arrays["dist_L"], arrays["dist_invKys"] = gathered
        meta["dist_n_dev"] = int(dist_post[0].shape[AXIS])
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
        if "dist_grid" in meta:
            raise NotImplementedError(
                "the checkpoint holds a 2-D grid posterior (gp_tpu's "
                "pchol2d): ROADMAP module 14, part 2, not ported yet")
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
        if meta["trained"] and "num_post" in meta:
            model._post = tuple(_post_tensor(z[f"post_{i}"], model)
                                for i in range(meta["num_post"]))
            model._trained = True
        model._post_aux = meta.get("post_aux")
        if meta["trained"] and "dist_n_dev" in meta:
            # attached by restore_distributed(mesh) on every process
            model._post_dist_pending = (
                meta["dist_n_dev"], meta["dist_block"], z["dist_L"],
                z["dist_invKys"])
            model._trained = True
        if "draws_state" in z:
            model.draws.gen.set_state(torch.from_numpy(z["draws_state"]))
    return model


def save_model_sharded(model, dirpath: str) -> None:
    """gp_tpu's sharded checkpoint (each process's own shards, no gather;
    checkpoint.py:179-339) is ROADMAP module 14, part 2."""
    raise NotImplementedError(
        "save_model_sharded is ROADMAP module 14, part 2, not ported yet; "
        "save_model gathers a 1-D distributed posterior")


def load_model_sharded(dirpath: str, mesh=None):
    """See save_model_sharded."""
    raise NotImplementedError(
        "load_model_sharded is ROADMAP module 14, part 2, not ported yet")
