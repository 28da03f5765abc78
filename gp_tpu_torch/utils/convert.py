"""The weights carrier: a trained model from plain state.

For a GP the "weights" are the hyperparameters and the training data (and,
for FITC and VFE, the inducing set and its jitter).  `gp_from_state` takes
them under gp_tpu/utils/checkpoint.py's names and returns a trained port
model whose posterior comes from its set_k on those hyperparameters (no
fit runs).  A checkpoint slice reuses it.
"""

from __future__ import annotations

import numpy as np

from ..models.exact import GP
from ..models.fitc import FITC
from ..models.vfe import VFE

MODELS = {"GP": GP, "FITC": FITC, "VFE": VFE}


def gp_from_state(state: dict, device=None):
    """A trained model from state with numpy arrays and plain values:

      x (n, d), y (n,), hyps (num_hyp,)   required
      model ("GP", "FITC" or "VFE", as gp_tpu's checkpoint meta names it)
      kernel  ("se_ard")   dtype (the model's default)   solver ("chol")
      noise_free (False)   noise_lb (1e-3)      optional
      inducing (m, d) (default x), jitter_u     FITC and VFE, optional

    kernel is any name in ops.kernels.KERNELS: se_ard, se_iso, matern52,
    matern32, rq and their _iso variants; hyps has that spec's num_hyp +
    2 entries (d + 4 for rq, 5 for rq_iso).  A sparse model's posterior is
    its set_k started from jitter_u (default (0.1 noise_lb)^2).
    """
    name = str(state.get("model", "GP"))
    if name not in MODELS:
        raise ValueError(f"model must be one of {sorted(MODELS)}; got "
                         f"{name!r}")
    gp = MODELS[name](np.asarray(state["x"]), np.asarray(state["y"]),
                      kernel=state.get("kernel", "se_ard"),
                      dtype=state.get("dtype"),
                      solver=state.get("solver", "chol"), device=device)
    if bool(state.get("noise_free", False)):
        gp.set_noise_free(True)
    if "noise_lb" in state:
        gp._noise_lb = float(state["noise_lb"])
    if name != "GP":
        if "inducing" in state:
            gp.set_inducing(np.asarray(state["inducing"]))
        gp._jitter_u = float(state.get("jitter_u",
                                       (0.1 * gp._noise_lb) ** 2))
    hyps = np.asarray(state["hyps"], np.float64)
    if hyps.shape != (gp.num_hyp,):
        raise ValueError(f"hyps must have {gp.num_hyp} entries for kernel "
                         f"{gp.kernel.name!r} at dim {gp.dim}; got "
                         f"{hyps.shape}")
    gp._hyps = gp._tensor(hyps)
    gp._update_posterior()
    gp._trained = True
    return gp
