"""Per cent of the profiled segment in which no operation ran on the
device (idle_share.<cell kind>: one reader for every cell)."""

from gpbench.readers import idle_share


def read(run):
    return idle_share(run)
