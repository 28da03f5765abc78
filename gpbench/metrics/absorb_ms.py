"""Milliseconds of BucketedGP.absorb: the host-clock span around each
call (absorb reads its pivot's check back, so it returns with its work
done)."""

from gpbench.readers import mean_span


def read(run):
    return mean_span(run, "absorb")
