"""Milliseconds a BO step: the window over every step it completed, each
episode's rebuild counted as one."""

from gpbench.readers import per_unit


def read(run):
    return per_unit(run, 1e3)
