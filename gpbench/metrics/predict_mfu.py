"""Per cent of the chip's peak: the model operations of every request in
the window (roofline.predict_request_flops) over the window."""

from gpbench.readers import mfu
from gpbench.roofline import predict_request_flops


def read(run):
    c = run.config
    return mfu(run, run.units * predict_request_flops(
        c["n"], c["d"], run.traffic["rows"]))
