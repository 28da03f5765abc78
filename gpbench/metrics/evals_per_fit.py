"""Objective evaluations a fit (LBFGSBResult.evals), over the window's
fits."""


def read(run):
    ev = run.counters.get("evals")
    return sum(ev) / len(ev) if ev else None
