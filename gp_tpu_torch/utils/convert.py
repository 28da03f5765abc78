"""The weights carrier: a trained GP from plain state.

For a GP the "weights" are the hyperparameters and the training data.
`gp_from_state` takes them under gp_tpu/utils/checkpoint.py's names and
returns a trained port GP whose posterior comes from `set_k` on those
hyperparameters (no fit runs).  A checkpoint slice reuses it.
"""

from __future__ import annotations

import numpy as np

from ..models.exact import GP


def gp_from_state(state: dict, device=None) -> GP:
    """A trained GP from state with numpy arrays and plain values:

      x (n, d), y (n,), hyps (num_hyp,)   required
      kernel  ("se_ard")   dtype (per device)   solver ("chol")
      noise_free (False)   noise_lb (1e-3)      optional

    kernel is any name in ops.kernels.KERNELS: se_ard, se_iso, matern52,
    matern32, rq and their _iso variants; hyps has that spec's num_hyp +
    2 entries (d + 4 for rq, 5 for rq_iso).
    """
    gp = GP(np.asarray(state["x"]), np.asarray(state["y"]),
            kernel=state.get("kernel", "se_ard"), dtype=state.get("dtype"),
            solver=state.get("solver", "chol"), device=device)
    if bool(state.get("noise_free", False)):
        gp.set_noise_free(True)
    if "noise_lb" in state:
        gp._noise_lb = float(state["noise_lb"])
    hyps = np.asarray(state["hyps"], np.float64)
    if hyps.shape != (gp.num_hyp,):
        raise ValueError(f"hyps must have {gp.num_hyp} entries for kernel "
                         f"{gp.kernel.name!r} at dim {gp.dim}; got "
                         f"{hyps.shape}")
    gp._hyps = gp._tensor(hyps)
    gp._update_posterior()
    gp._trained = True
    return gp
