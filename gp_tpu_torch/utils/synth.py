"""Deterministic synthetic regression data (a copy of gp_tpu's
benchmarks/synth.make_data): every consumer regenerates bit-identical data
from the seed."""

from __future__ import annotations

import numpy as np


def make_data(n: int, d: int = 10, seed: int = 42, noise: float = 0.1):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (n, d))
    y = (np.sin(2.0 * X[:, 0]) + 0.5 * np.cos(3.0 * X[:, 1])
         + 0.3 * X[:, 2] * X[:, 3] + 0.2 * np.sin(X[:, 4] * X[:, 5])
         + 0.1 * X[:, 6] - 0.15 * np.abs(X[:, 7])
         + noise * rng.standard_normal(n))
    return X, y
