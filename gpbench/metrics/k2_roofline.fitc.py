"""Per cent of its roofline that K2 (se_tile with SYM = false) reaches in
the profiled train() of a FITC cell: each launch's byte-or-operation
bound (roofline.se_bound_ms, not symmetric) over the launches' device
time.  For the fitc family alone: the reader counts every K2 launch of
the profiled segment as FITC's.

In a FITC train() every K2 launch is one of a pair at the same two
shapes, Kuu (M, M) and Kxu (N, M), in the configuration's dtype: the
objective's (under `objective.kxu`), the start and final nll() probes' and
set_k's.  So the bound is that of a pair times half the launches.  The
profiled segment holds kernel time by name, not by span; outside the
objective's two an evaluation there are six launches (the two nll()
probes' and set_k's), at the same shapes.  None where the configuration
is not a fitc one, where the segment holds no K2 launch, or an odd count
of them (a launch that is not one of a pair)."""

from gpbench.readers import kernel_time
from gpbench.roofline import se_bound_ms


def read(run):
    if run.config.get("family") != "fitc":
        return None
    hit = kernel_time(run, r"se_tile<[^,]+,\s*\d+,\s*false")
    if hit is None or hit[0] % 2:
        return None
    c = run.config
    n, m, d, dtype = c["n"], c["m"], c["d"], c["dtype"]
    pair_ms = (se_bound_ms(n, m, d, dtype, False)[0]
               + se_bound_ms(m, m, d, dtype, False)[0])
    return 100.0 * pair_ms * (hit[0] // 2) / (hit[1] * 1e3)
