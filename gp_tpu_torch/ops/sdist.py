"""Pairwise squared Euclidean distances (counterpart of gp_tpu/ops/sdist.py).

`sqdist` is the quadratic-expansion form |a|^2 + |b|^2 - 2 a.b clamped at
0, the same formula and evaluation order as gp_tpu's (and as the CUDA
tile kernel in csrc/se_tile.cu), so the two agree to rounding.
`sqdist_exact` is the difference-based form without cancellation.
"""

from __future__ import annotations

import torch


def sqdist(x1, x2):
    """Squared distances between rows of x1 (n1, d) and x2 (n2, d)."""
    n1sq = torch.sum(x1 * x1, dim=1)[:, None]
    n2sq = torch.sum(x2 * x2, dim=1)[None, :]
    cross = x1 @ x2.T
    return torch.clamp(n1sq + n2sq - 2.0 * cross, min=0.0)


def sqdist_exact(x1, x2):
    """Difference-based squared distances (no cancellation), O(n1 n2 d)."""
    diff = x1[:, None, :] - x2[None, :, :]
    return torch.sum(diff * diff, dim=-1)


def sqdist_vm(v, m):
    """Squared distances between one point v (d,) and the rows of m (n, d)."""
    diff = m - v[None, :]
    return torch.sum(diff * diff, dim=-1)
