"""Device idle milliseconds per evaluation that fall to the optimizer's
host loop: the gaps of 20 us or more whose midpoint has `train` as the
innermost open span (no objective, probe or posterior open), over the
`objective` spans (program_trace.py)."""

from gpbench.program_trace import leaf, per_span


def read(run):
    return per_span(run, "idle_s", lambda p: leaf(p) == "train", "objective")
