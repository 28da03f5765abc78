"""Milliseconds of a step's acquisition: the host-clock span around both
*_with_grad predictions and the read-back of their results."""

from gpbench.readers import mean_span


def read(run):
    return mean_span(run, "acq")
