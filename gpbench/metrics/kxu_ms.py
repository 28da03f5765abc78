"""Device milliseconds of the sparse objective's covariance builds (K2 of
Kxu and Kuu, and diag Kxx) per NLL + gradient evaluation: the operations
launched under `objective.kxu` directly inside `objective` over the
`objective` spans (program_trace.py).  The start probe's and the final
nll()'s builds, under `nll`, are left out."""

from gpbench.program_trace import per_span


def read(run):
    return per_span(run, "device_s",
                    lambda p: p.endswith("objective/objective.kxu"),
                    "objective")
