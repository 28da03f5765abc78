"""Device milliseconds of one NLL + gradient evaluation: the busy time of
the profiled train() (a fit capped at the traffic's profile_evals) over
the evaluations its optimizer made.  train()'s start probe and final
posterior, three factorizations, are counted in."""


def read(run):
    seg, evals = run.segment, run.counters.get("profile_evals")
    if not seg or not evals or seg["busy_s"] <= 0:
        return None
    return seg["busy_s"] / evals[0] * 1e3
