"""Device milliseconds per absorb of its chol_solve for invKys over the
capacity buffer: the operations launched under `absorb.solve` over the
`absorb` spans of the traced BO episode (program_trace.py)."""

from gpbench.program_trace import leaf, per_span


def read(run):
    return per_span(run, "device_s", lambda p: leaf(p) == "absorb.solve",
                    "absorb")
