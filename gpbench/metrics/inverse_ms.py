"""Device milliseconds of the objective's explicit inverse (the blocked
lauum spd_inv_from_chol, or the library's) per evaluation: the
operations launched under `objective.inverse` over the `objective`
spans (program_trace.py)."""

from gpbench.program_trace import leaf, per_span


def read(run):
    return per_span(run, "device_s", lambda p: leaf(p) == "objective.inverse",
                    "objective")
