"""The 95th percentile of the window's BO step latencies, in ms: each
step on the host's clock, from its call to its answers read back and its
absorb returned (rebuilds included)."""

import numpy as np


def read(run):
    return float(np.percentile(run.unit_s, 95)) * 1e3 if run.unit_s else None
