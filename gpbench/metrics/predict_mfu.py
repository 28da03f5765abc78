"""Per cent of the chip's peak: the model operations of every request in
the window (the model family's predict_request_flops) over the window."""

from gpbench.readers import mfu


def read(run):
    return mfu(run, run.units * run.family.predict_request_flops(
        run.config, run.traffic["rows"]))
