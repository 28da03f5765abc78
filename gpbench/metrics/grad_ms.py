"""Device milliseconds of the objective's gradient contraction
(k_noise_vjp_q, or the generic vjp of the K1 build) per evaluation: the
operations launched under `objective.grad` over the `objective` spans
(program_trace.py)."""

from gpbench.program_trace import leaf, per_span


def read(run):
    return per_span(run, "device_s", lambda p: leaf(p) == "objective.grad",
                    "objective")
