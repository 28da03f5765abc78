"""The weights carrier: a model from plain state.

For a GP the "weights" are the hyperparameters and the training data (and,
for FITC and VFE, the inducing set and its jitter).  `model_from_state`
takes them under gp_tpu/utils/checkpoint.py's names and returns an
untrained port model; `gp_from_state` also computes its posterior by its
set_k at those hyperparameters (no fit runs).  utils/checkpoint.py builds
its models with the first and installs the saved posterior instead.
"""

from __future__ import annotations

import numpy as np

from ..config import DEFAULT_SEED
from ..models.bucketed import BucketedGP
from ..models.exact import GP
from ..models.fitc import FITC
from ..models.vfe import VFE

MODELS = {"GP": GP, "FITC": FITC, "VFE": VFE, "BucketedGP": BucketedGP}


def model_from_state(state: dict, device=None):
    """An untrained model from state with numpy arrays and plain values:

      x (n, d), y (n,)                          required
      hyps (num_hyp,)
      model ("GP", "FITC", "VFE" or "BucketedGP", as gp_tpu's checkpoint
             meta names it)
      kernel ("se_ard")   dtype (the model's default)   solver ("chol")
      noise_free (False)   noise_lb (1e-3)   seed (0)
      bucket (64)                               BucketedGP
      inducing (m, d) (default x), jitter_u     FITC and VFE

    kernel is any name in ops.kernels.KERNELS: se_ard, se_iso, matern52,
    matern32, rq, their _iso variants and gp_tpu's se_*_pallas / se_*_xla;
    hyps has that spec's num_hyp + 2 entries (d + 4 for rq, 5 for rq_iso).
    A sparse model's jitter defaults to (0.1 noise_lb)^2.
    """
    name = str(state.get("model", "GP"))
    if name not in MODELS:
        raise ValueError(f"model must be one of {sorted(MODELS)}; got "
                         f"{name!r}")
    kw = {"kernel": state.get("kernel", "se_ard"),
          "dtype": state.get("dtype"), "solver": state.get("solver", "chol"),
          "seed": int(state.get("seed", DEFAULT_SEED)), "device": device}
    if name == "BucketedGP":
        kw["bucket"] = int(state.get("bucket", 64))
    gp = MODELS[name](np.asarray(state["x"]), np.asarray(state["y"]), **kw)
    if bool(state.get("noise_free", False)):
        gp.set_noise_free(True)
    if "noise_lb" in state:
        gp._noise_lb = float(state["noise_lb"])
    if name in ("FITC", "VFE"):
        if "inducing" in state:
            gp.set_inducing(np.asarray(state["inducing"]))
        gp._jitter_u = float(state.get("jitter_u",
                                       (0.1 * gp._noise_lb) ** 2))
    if "hyps" in state:
        hyps = np.asarray(state["hyps"], np.float64)
        if hyps.shape != (gp.num_hyp,):
            raise ValueError(f"hyps must have {gp.num_hyp} entries for "
                             f"kernel {gp.kernel.name!r} at dim {gp.dim}; "
                             f"got {hyps.shape}")
        gp._hyps = gp._tensor(hyps)
    return gp


def gp_from_state(state: dict, device=None):
    """A trained model from state (model_from_state's keys, hyps
    required): the posterior is the model's set_k at hyps (a sparse
    model's started from jitter_u)."""
    if "hyps" not in state:
        raise KeyError("state has no 'hyps'")
    gp = model_from_state(state, device)
    gp._update_posterior()
    gp._trained = True
    return gp
