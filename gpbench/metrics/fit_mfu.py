"""Per cent of the chip's peak: the model operations of every objective
evaluation in the window (the model family's fit_eval_flops) over the
window."""

from gpbench.readers import mfu


def read(run):
    ev = run.counters.get("evals")
    if not ev:
        return None
    return mfu(run, sum(ev) * run.family.fit_eval_flops(run.config))
