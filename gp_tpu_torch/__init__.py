"""gp_tpu_torch — gp_tpu's exact and sparse GPs on PyTorch and CUDA.

A port of gp_tpu (JAX, TPU) to PyTorch on an NVIDIA H100.  The covariance
builds of every kernel family (SE, Matern-5/2, Matern-3/2, RQ) run through
a hand-written CUDA kernel (csrc/se_tile.cu), built with nvcc at first use
on a CUDA tensor.  Entry points run on CUDA unless the caller passes
device="cpu".

    from gp_tpu_torch import GP
    gp = GP(X, y)                # CUDA, float32, SE-ARD
    nll = gp.train()
    mu, s2 = gp.batch_predict(Xs)
    gp = GP(X, y, kernel="matern52")   # or any name in KERNELS
    gp.train_multistart(n_starts=4)    # multi-start L-BFGS-B
    fitc = FITC(X, y)            # CUDA, float64; also VFE
    fitc.set_inducing(X[-512:])
    fitc.train()
"""

from .config import INF, default_dtype
from .models.exact import GP
from .models.fitc import FITC
from .models.vfe import VFE
from .ops.kernels import KERNELS, SE_ARD, SE_ISO, get_kernel
from .ops.kernels_extra import (MATERN32, MATERN32_ISO, MATERN52,
                                MATERN52_ISO, RQ, RQ_ISO)

__all__ = ["GP", "FITC", "VFE", "SE_ARD", "SE_ISO", "MATERN52", "MATERN52_ISO",
           "MATERN32", "MATERN32_ISO", "RQ", "RQ_ISO", "KERNELS",
           "get_kernel", "INF", "default_dtype"]
