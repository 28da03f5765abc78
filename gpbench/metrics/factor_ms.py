"""Device milliseconds of the objective's Cholesky factor (the blocked
route with its K3 leaves, or the library's) per NLL + gradient
evaluation: the device operations launched under the program's
`objective.factor` spans over its `objective` spans, in the traced piece
(program_trace.py)."""

from gpbench.program_trace import leaf, per_span


def read(run):
    return per_span(run, "device_s", lambda p: leaf(p) == "objective.factor",
                    "objective")
