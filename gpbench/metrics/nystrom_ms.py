"""Device milliseconds of the sparse objective's Nystrom algebra (V =
Luu^-1 Kux, its column norms, Gamma and the weighted Gram Kux Gamma^-1
Kxu) per NLL + gradient evaluation: the operations launched under
`objective.nystrom` directly inside `objective` over the `objective`
spans (program_trace.py).  The probes' under `nll` are left out."""

from gpbench.program_trace import per_span


def read(run):
    return per_span(run, "device_s",
                    lambda p: p.endswith("objective/objective.nystrom"),
                    "objective")
