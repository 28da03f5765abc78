"""Host reads of device scalars per evaluation in the traced train(): the
program's `host_sync.*` counters (the optimizer's acceptance, curvature
and stopping tests, the start probe, set_k) over its `objective` spans
(program_trace.py)."""

from gpbench.program_trace import n_spans, program


def read(run):
    p = program(run)
    n = n_spans(p, "objective") if p else 0
    if not n:
        return None
    return sum(v for k, v in p["counters"].items()
               if k.startswith("host_sync.")) / n
