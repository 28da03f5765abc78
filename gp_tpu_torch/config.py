"""Global configuration for gp_tpu_torch (counterpart of gp_tpu/config.py).

Precision policy: float64 on the CPU (parity with the reference's Eigen
doubles), float32 on CUDA.  Reduced-precision products are switched off
at import: gp_tpu measured that a bf16/TF32-class matmul collapses the
exact-GP fit to the constant predictor (gp_tpu/config.py:29-39), so every
float32 product here runs in full float32.

Devices: the entry points run on the card unless the caller asks for the
CPU.  `resolve_device(None)` is CUDA and raises when there is no CUDA
device; it never falls back to the CPU.
"""

from __future__ import annotations

import torch

# Mirror of the reference's global INF objective sentinel (def.h:12).
INF = float("inf")

# Default RNG seed (def.cpp:10-16).
DEFAULT_SEED = 0

# IEEE double limits used by the reference's hyper-range formulas
# (CovSEard.cpp:44,59,62,68-69); host-side Python floats.
DBL_EPS = 2.220446049250313e-16
DBL_MIN = 2.2250738585072014e-308
DBL_MAX = 1.7976931348623157e+308

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless `device` says
    otherwise.  Raises when CUDA is asked for (explicitly or by default)
    and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gp_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def default_dtype(device) -> torch.dtype:
    """float64 on the CPU, float32 on CUDA (gp_tpu/config.py:68-78)."""
    return torch.float64 if torch.device(device).type == "cpu" \
        else torch.float32


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ("float32")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).rsplit(".", 1)[-1]
    if name not in ("float32", "float64"):
        raise ValueError(f"unsupported dtype {dtype!r}; use float32 or "
                         f"float64")
    return getattr(torch, name)


def machine_eps(dtype) -> float:
    """numeric_limits<double>::epsilon() analog for the working dtype."""
    return float(torch.finfo(as_dtype(dtype)).eps)
