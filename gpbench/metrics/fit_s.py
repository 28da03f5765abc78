"""Seconds a fit: the window over the fits it completed (train() from the
library's start and the held-out predictions, back to back)."""

from gpbench.readers import per_unit


def read(run):
    return per_unit(run)
