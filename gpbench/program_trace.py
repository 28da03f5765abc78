"""The program's own spans laid over a device trace, for the per-layer
metrics that read them (metrics/factor_ms.py and the others that import
this module), in a --trace 1 run only.

The first of those readers that a run calls runs the traffic kind's
profiled piece (loops.py `profile`: one train() capped at profile_evals,
one request, or one BO episode) once more, after the window, the profiled
segment (trace.py) and the judge, which it leaves as they were.  It builds
the program afresh (`TracedPort`), runs the kind's setup() on a copy of
the run, so that nothing the run holds changes, and then the piece inside
the program's tracer (gp_tpu_torch.utils.profiling.tracing) under a
profiler with trace.Segment's activity set (`ProgramSegment`).  Spans and
profiler events are on one clock: the host's Unix-epoch nanoseconds.

  (a) each device operation goes to the innermost span that was open when
      the runtime call that launched it started (the two matched by the
      profiler's correlation id), and is counted once;
  (b) each idle gap between device intervals of GAP_NS or more goes to
      the innermost span open at its midpoint.

Where no span was open the time goes to NO_SPAN.  On the CPU (the tests)
the work is the host's top-level operations, each launched at its own
start.  The reduction is kept as run.program:

  spans       {path: spans closed}, a path being the span's name and its
              ancestors', outermost first, joined by "/";
  device_s    {path or NO_SPAN: device seconds}, by (a);
  idle_s      {path or NO_SPAN: idle seconds}, by (b);
  short_idle_s  the idle seconds in gaps under GAP_NS;
  counters    the tracer's counters; launches: the kernel wrappers'
              launches over the piece;
  busy_s, window_s  as trace.Segment's.

A program without the tracer (an older gp_tpu_torch) gives run.program =
None, and every reader here None.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict

import torch

from .loops import KINDS
from .program import Port
from .trace import GAP_NS, _device_work, _on_host, sync

NO_SPAN = "(no program span)"


class TracedPort(Port):
    """Port, with the program's tracer."""

    def tracer(self):
        """gp_tpu_torch's tracing() context manager, or None where the
        program has none."""
        from gp_tpu_torch.utils import profiling
        return getattr(profiling, "tracing", None)


class ProgramSegment:
    """trace.Segment's start() / stop(), with the program's tracer on in
    between; `result` is the reduction above, `trace` the tracer's Trace,
    `events` the profiler's."""

    def __init__(self, device, tracing):
        self.device = torch.device(device)
        self.tracing = tracing
        self.result = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CUDA
                if self.device.type == "cuda"
                else torch.profiler.ProfilerActivity.CPU]
        sync(self.device)
        self._ctx = self.tracing()
        self.trace = self._ctx.__enter__()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        sync(self.device)
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        self._ctx.__exit__(None, None, None)
        self.events = self.prof.profiler.kineto_results.events()
        self.prof = None
        self.result = reduce(work(self.events, self.device.type == "cuda"),
                             self.trace, window_s)


def work(events, cuda: bool) -> list:
    """(launch_ns, start_ns, end_ns, name) of each operation: on the card
    each device operation, launched at the start of the runtime call of
    its correlation id (its own start where none is recorded); on the CPU
    each top-level host operation."""
    if cuda:
        launch = {e.correlation_id(): e.start_ns() for e in events
                  if _on_host(e)}
        out = []
        for e in events:
            if _device_work(e):
                s = e.start_ns()
                out.append((launch.get(e.correlation_id(), s), s,
                            s + e.duration_ns(), e.name()))
        return out
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in events
                 if _on_host(e) and not e.is_user_annotation())
    out, end = [], None
    for s, t, name in ops:
        if end is None or s >= end:
            out.append((s, s, t, name))
            end = t
    return out


def innermost(trace):
    """f(t_ns) -> the index of the innermost span open at t, or -1.  The
    spans nest (one host thread opens them), in the order they opened."""
    spans = trace.spans
    times, idx, stack = [], [], []

    def mark(t, i):
        times.append(t)
        idx.append(i)

    for i, (_, _, b, e) in enumerate(spans):
        while stack and spans[stack[-1]][3] <= b:
            j = stack.pop()
            mark(spans[j][3], stack[-1] if stack else -1)
        stack.append(i)
        mark(b, i)
    while stack:
        j = stack.pop()
        mark(spans[j][3], stack[-1] if stack else -1)

    def at(t: int) -> int:
        k = bisect.bisect_right(times, t) - 1
        return idx[k] if k >= 0 else -1
    return at


def reduce(work_ops: list, trace, window_s: float) -> dict:
    at = innermost(trace)
    paths = [trace.path(i) for i in range(len(trace.spans))]

    def label(t: int) -> str:
        i = at(t)
        return paths[i] if i >= 0 else NO_SPAN

    spans = defaultdict(int)
    for i, s in enumerate(trace.spans):
        if s[3]:
            spans[paths[i]] += 1
    device_s, idle_s = defaultdict(float), defaultdict(float)
    for launched, s, t, _ in work_ops:
        device_s[label(launched)] += (t - s) * 1e-9
    busy, short, end = 0, 0, None
    for _, s, t, _ in sorted(work_ops, key=lambda w: w[1]):
        if end is None or s > end:
            if end is not None:
                if s - end >= GAP_NS:
                    idle_s[label((s + end) // 2)] += (s - end) * 1e-9
                else:
                    short += s - end
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return {"spans": dict(spans), "device_s": dict(device_s),
            "idle_s": dict(idle_s), "short_idle_s": short * 1e-9,
            "counters": dict(trace.counters),
            "launches": dict(trace.launches),
            "busy_s": busy * 1e-9, "window_s": window_s}


def _measure(run):
    port = TracedPort(run.family, run.config, run.device)
    tracing = port.tracer()
    if tracing is None:
        port.close()
        return None
    shadow = dataclasses.replace(run, counters=defaultdict(list),
                                 answers=[], unit_s=[], spans={},
                                 segment=None)
    loop = KINDS[run.traffic["kind"]](shadow, port)
    seg = ProgramSegment(run.device, tracing)
    try:
        loop.setup()
        loop.profile(seg)
    finally:
        loop.close()
    seg.events = None
    _log(run, seg.result)
    return seg.result


def _log(run, p) -> None:
    """One stderr line: what (a) and (b) put down to spans."""
    dev, idle = p["device_s"], p["idle_s"]
    top = lambda d: ", ".join(f"{k} {v:.6f}" for k, v in sorted(
        d.items(), key=lambda kv: -kv[1])[:4])
    run.log(f"program trace: busy {p['busy_s']:.6f} of {p['window_s']:.6f} "
            f"s; device ops {sum(dev.values()):.6f} s, "
            f"{dev.get(NO_SPAN, 0.0):.6f} under no span; idle in gaps of "
            f"20 us or more {sum(idle.values()):.6f} s, "
            f"{idle.get(NO_SPAN, 0.0):.6f} under no span; device s by span: "
            f"{top(dev)}; idle s by span: {top(idle)}")


def program(run):
    """run.program, measured on the first call of a traced run; None in
    an untraced run or where the program has no tracer."""
    if "program" not in vars(run):
        run.program = _measure(run) if run.trace else None
    return run.program


def leaf(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def n_spans(p: dict, name: str) -> int:
    return sum(k for path, k in p["spans"].items() if leaf(path) == name)


def per_span(run, key: str, pick, denom: str, scale: float = 1e3):
    """The sum of run.program[key] over the paths `pick` takes, per span
    named `denom` (times `scale`); None without a program trace or such a
    span."""
    p = program(run)
    if not p:
        return None
    n = n_spans(p, denom)
    if not n:
        return None
    return sum(v for path, v in p[key].items() if pick(path)) / n * scale
