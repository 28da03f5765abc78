"""Model checkpoint / resume in gp_tpu's file format (counterpart of
gp_tpu/utils/checkpoint.py:24-176).

A fitted model (training data, hyperparameters and the posterior cache:
the Cholesky factors and alpha) is written to one ``.npz``, so that a
prediction service resumes without refactorizing.  The format is
gp_tpu's: numpy savez with a ``meta`` json string (format_version, model,
kernel, solver, dtype by name, noise_lb, noise_free, fixhyps, trained,
num_post, bucket, jitter_u) and the arrays x, y, hyps, inducing, post_<i>
and key.  Each package loads the other's files:

  * the posterior tuples are gp_tpu's: GP (L, invKys); BucketedGP
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

Not carried: the distributed posterior (dist_* fields) and the sharded
checkpoint (checkpoint.py:179-339) are ROADMAP module 14, and a file that
holds one raises.
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


def save_model(model, path: str) -> None:
    """Serialize a (possibly trained) model to `path` (.npz)."""
    trained = model._trained
    if trained and model._post is None:
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
    if trained:
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
        if "dist_n_dev" in meta or "dist_grid" in meta:
            raise NotImplementedError(
                "the checkpoint holds a distributed posterior; the "
                "distributed layer is ROADMAP module 14, not ported yet")
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
            model._post = tuple(
                torch.from_numpy(z[f"post_{i}"]).to(device=model.device,
                                                    dtype=model.dtype)
                for i in range(meta["num_post"]))
            model._trained = True
        model._post_aux = meta.get("post_aux")
        if "draws_state" in z:
            model.draws.gen.set_state(torch.from_numpy(z["draws_state"]))
    return model
