"""Device milliseconds per BO step of the variance's triangular solves
against the factor (forward only): the operations launched under
`predict.solve` inside `predict.var_grad`, over the `predict.var_grad`
spans of the traced episode (program_trace.py)."""

from gpbench.program_trace import per_span


def read(run):
    return per_span(run, "device_s",
                    lambda p: p.endswith("predict.var_grad/predict.solve"),
                    "predict.var_grad")
