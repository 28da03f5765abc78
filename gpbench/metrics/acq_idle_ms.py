"""Device idle milliseconds per BO step inside the acquisition: the gaps
of 20 us or more whose midpoint falls under `predict.mean_grad` or
`predict.var_grad` (or a span inside them), over the `predict.var_grad`
spans of the traced episode (program_trace.py)."""

from gpbench.program_trace import per_span

GRADS = {"predict.mean_grad", "predict.var_grad"}


def read(run):
    return per_span(run, "idle_s", lambda p: bool(GRADS & set(p.split("/"))),
                    "predict.var_grad")
