"""Text matrix I/O of the reference's file contract (counterpart of
gp_tpu/utils/io.py).

The reference reads whitespace-separated text matrices (util.cpp:29-62,
`read_matrix`) and its drivers write a two-column `pred` file of posterior
mean and standard deviation (mygp.cpp:31-36).  The native reader and
writer (native/fastio.py) serve when g++ can build them, NumPy's
otherwise; both give the same values.  Arrays are NumPy arrays on the
host: this is where the CLI's data enters and its predictions leave.
"""

from __future__ import annotations

import os

import numpy as np

from ..native import fastio


def read_matrix(path: str) -> np.ndarray:
    """A whitespace-separated text matrix as (rows, cols) float64.

    Mirrors util.cpp:29-62: every row must have the same number of columns;
    an empty or unreadable file is an error."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    arr = fastio.read_matrix(path)
    if arr is None:
        arr = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if arr.size == 0:
        raise ValueError(f"Empty matrix in file {path}")
    return arr


def write_matrix(path: str, m, fmt: str = "%.18g") -> None:
    """Write m as text, one row a line.  A "%.<k>g" format goes through the
    native writer at min(k, 17) significant digits (17 round-trips every
    float64 exactly); any other through np.savetxt."""
    m = np.asarray(m)
    if fmt.startswith("%.") and fmt.endswith("g"):
        digits = min(int(fmt[2:-1]), 17)
        if fastio.write_matrix(path, m, digits):
            return
    np.savetxt(path, m, fmt=fmt)


def write_pred(path: str, mean: np.ndarray, stddev: np.ndarray) -> None:
    """The two-column prediction file of the reference's drivers
    (mygp.cpp:31-36): column 0 the posterior mean, column 1 the posterior
    standard deviation."""
    rec = np.stack([np.asarray(mean).ravel(), np.asarray(stddev).ravel()],
                   axis=1)
    write_matrix(path, rec)
