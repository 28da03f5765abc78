"""The two dense helpers of gp_tpu/ops/blocked.py that the exact-GP path
calls off the TPU: `add_diag` and `spd_inv_from_chol`.

Not carried, and why: gp_tpu's panel-blocked Cholesky, `tri_inv`, the
blocked triangular solves, the column slabs (ops/slabbed.py) and the
far-pad decoy rows exist to feed large GEMMs to the TPU's MXU and to stay
inside XLA:TPU's int32 buffer addressing (blocked.py:30-35).  gp_tpu
itself takes them only on the TPU (`chol._use_blocked`); on any other
backend it calls the library factorization and leaves the inverse to XLA.
The port does the same with the library calls of the card.
"""

from __future__ import annotations

import torch


def add_diag(K, c):
    """K + c I, in place on K's diagonal (O(N)); returns K."""
    K.diagonal(dim1=-2, dim2=-1).add_(c)
    return K


def spd_inv_from_chol(L):
    """K^-1 from K = L L^T: a library call (`torch.cholesky_inverse`) for
    work that gp_tpu leaves to XLA off the TPU.  A NaN factor gives a NaN
    inverse, which the objective's sanitizer turns into INF."""
    return torch.cholesky_inverse(L)
