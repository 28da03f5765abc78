"""Per cent of its roofline that K1 (se_tile with SYM = true: K + sn2 I of
the training rows) reaches in the profiled segment: its byte bound at
(n, n, d) times its launches, over its device time (k1_roofline.<cell
kind>: one reader for every cell)."""

from gpbench.readers import kernel_time
from gpbench.roofline import se_bound_ms


def read(run):
    hit = kernel_time(run, r"se_tile<[^,]+,\s*\d+,\s*true")
    if hit is None:
        return None
    n, d, dtype = run.config["n"], run.config["d"], run.config["dtype"]
    bound_ms, _ = se_bound_ms(n, n, d, dtype, True)
    return 100.0 * bound_ms * hit[0] / (hit[1] * 1e3)
