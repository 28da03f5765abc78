"""Per cent of the chip's peak: the model operations of every objective
evaluation in the window (roofline.fit_eval_flops) over the window."""

from gpbench.readers import mfu
from gpbench.roofline import fit_eval_flops


def read(run):
    ev = run.counters.get("evals")
    if not ev:
        return None
    return mfu(run, sum(ev) * fit_eval_flops(run.config["n"],
                                             run.config["d"]))
