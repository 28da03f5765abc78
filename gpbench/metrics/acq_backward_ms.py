"""Device milliseconds per BO step of the acquisition's autograd
backward (the mean's and the variance's input gradients): the
operations launched under `predict.backward`, over the
`predict.var_grad` spans of the traced episode (program_trace.py)."""

from gpbench.program_trace import leaf, per_span


def read(run):
    return per_span(run, "device_s", lambda p: leaf(p) == "predict.backward",
                    "predict.var_grad")
