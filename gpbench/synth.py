"""Seeded synthetic regression data: a copy of gp_tpu_torch.utils.synth
(itself gp_tpu's benchmarks/synth.make_data), kept with the benchmark so
that a change to the program cannot change the inputs.

`seed` may be an int or a sequence of ints (numpy's default_rng takes
both): the harness derives one stream per unit of work from the run's
--seed, e.g. (seed, "fit" tag, i).
"""

from __future__ import annotations

import numpy as np


def make_data(n: int, d: int = 10, seed=42, noise: float = 0.1):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (n, d))
    y = (np.sin(2.0 * X[:, 0]) + 0.5 * np.cos(3.0 * X[:, 1])
         + 0.3 * X[:, 2] * X[:, 3] + 0.2 * np.sin(X[:, 4] * X[:, 5])
         + 0.1 * X[:, 6] - 0.15 * np.abs(X[:, 7])
         + noise * rng.standard_normal(n))
    return X, y


def uniform_rows(n: int, d: int, seed) -> np.ndarray:
    """n points uniform in make_data's box [-2, 2]^d."""
    return np.random.default_rng(seed).uniform(-2.0, 2.0, (n, d))
