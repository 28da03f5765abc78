"""Seconds a request: the window over the mean-and-variance requests it
completed."""

from gpbench.readers import per_unit


def read(run):
    return per_unit(run)
