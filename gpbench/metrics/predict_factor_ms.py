"""Device milliseconds per request of the stream posterior's
refactorization (the K1 build and the blocked Cholesky of
_factor_k_noise): the operations launched under `predict.factor` over
the `predict` spans of the traced request (program_trace.py)."""

from gpbench.program_trace import leaf, per_span


def read(run):
    return per_span(run, "device_s", lambda p: leaf(p) == "predict.factor",
                    "predict")
