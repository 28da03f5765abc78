"""The program's tracer, off by default (counterpart of
gp_tpu/utils/profiling.py).

  * `span(name)`: a named range of the program's own work.  Off, it
    returns one shared no-op context manager: no allocation, no clock, no
    synchronization.  On, it records (name, parent, t_begin_ns, t_end_ns)
    on the host's Unix-epoch nanosecond clock (time.time_ns), the clock
    torch.profiler gives its host and device events, so that a span can be
    laid over a profiler trace; it records no CUDA event and adds no
    synchronization;
  * `count(name, k)`: a named counter (off: a flag test);
  * `host_read(t, site)`: the program's one way to read a device scalar
    back on the host (a sync where t is on the card); on, it counts one
    under "host_sync.<site>";
  * `tracing()`: the only switch.  It yields a `Trace` that collects the
    spans and counters of its extent, and, at its end, the launches of the
    kernel wrappers' counters (ops/se_tile.py, ops/chol_block.py,
    ops/qr_pivot.py) over that extent;
  * `device_trace(logdir)`: a torch.profiler trace of the CPU and the card,
    written to logdir as a Chrome trace (chrome://tracing, Perfetto):
    per-kernel device time and the gaps between launches; with the tracer
    on inside it, each span is also a record_function range of the trace.

The fallback counters (`fallback.*`) are the operator's signal that a
path took its expensive branch: `absorb_refactor`, an absorb that
refactorized, O(N^3) in place of O(N^2); `set_k_inflation`, a sqrt(10)
noise inflation of set_k; `stream_rescue`, a failed candidate of
set_k_streamed's rescue.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import Counter
from dataclasses import dataclass, field

import torch

# the tracer's state: only tracing() sets it
_trace = None
# device_trace's depth: spans are also record_function ranges inside it
_annotate = 0


@dataclass
class Trace:
    """What one tracing() extent recorded.

    spans     [name, parent index (-1: none), t_begin_ns, t_end_ns], in
              the order they opened;
    counters  {name: count};
    launches  {"<module>.<entry>[.<form>]": launches over the extent},
              the wrappers' own counters read at the start and the end."""
    spans: list = field(default_factory=list)
    counters: Counter = field(default_factory=Counter)
    launches: dict = field(default_factory=dict)
    _open: list = field(default_factory=list, repr=False)

    def path(self, i: int) -> str:
        """The span's name and its ancestors', outermost first, joined by
        "/"."""
        names = []
        while i >= 0:
            names.append(self.spans[i][0])
            i = self.spans[i][1]
        return "/".join(reversed(names))


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "i", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        t = _trace
        self.i = len(t.spans)
        t.spans.append([self.name, t._open[-1] if t._open else -1,
                        time.time_ns(), 0])
        t._open.append(self.i)
        self.rf = None
        if _annotate:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return None

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t = _trace
        t.spans[self.i][3] = time.time_ns()
        t._open.pop()
        return False


def span(name: str):
    """`with span("objective.factor"): ...`: a span while tracing is on,
    else a shared no-op."""
    if _trace is None:
        return _NO_SPAN
    return _Span(name)


def count(name: str, k: int = 1) -> None:
    if _trace is not None:
        _trace.counters[name] += k


def host_read(t, site: str):
    """t.item(): a bool tensor reads as bool, a floating one as float.
    Counts one "host_sync.<site>" while tracing is on."""
    if _trace is not None:
        _trace.counters["host_sync." + site] += 1
    return t.item()


def _launch_counts() -> dict:
    """The kernel wrappers' launch counters, flattened."""
    from ..ops import chol_block, qr_pivot, se_tile
    out = {}
    for mod, counts in (("se_tile", se_tile.launches),
                        ("chol_block", chol_block.launches),
                        ("qr_pivot", qr_pivot.launches)):
        for entry, v in counts.items():
            if isinstance(v, dict):
                for form, k in v.items():
                    out[f"{mod}.{entry}.{form}"] = k
            else:
                out[f"{mod}.{entry}"] = v
    return out


@contextlib.contextmanager
def tracing():
    """`with tracing() as t: ...`: the tracer on over the block; t is the
    Trace.  Not reentrant."""
    global _trace
    if _trace is not None:
        raise RuntimeError("tracing() is already on")
    t = Trace()
    before = _launch_counts()
    _trace = t
    try:
        yield t
    finally:
        _trace = None
        after = _launch_counts()
        t.launches = {k: v - before.get(k, 0) for k, v in after.items()
                      if v != before.get(k, 0)}


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler over the block, CPU and (where present) CUDA
    activity, exported to logdir/trace.json; yields the profiler
    (key_averages() sums the time by kernel).  Spans opened inside it
    while tracing() is on appear as ranges of the trace."""
    global _annotate
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        _annotate += 1
        try:
            yield prof
            _sync()
        finally:
            _annotate -= 1
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
