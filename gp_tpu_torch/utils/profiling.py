"""Tracing and profiling helpers (counterpart of gp_tpu/utils/profiling.py).

  * `phase(name)`: the wall clock of a phase, with the card's queued work
    finished at both ends (torch.cuda.synchronize), so that a phase
    measures the device's work and not its enqueue;
  * `device_trace(logdir)`: a torch.profiler trace of the CPU and the card,
    written to logdir as a Chrome trace (chrome://tracing, Perfetto):
    per-kernel device time and the gaps between launches;
  * `Timer`: accumulating named phase timers, with the device time of each
    phase from CUDA events where the card is in use.

On a process that has not touched CUDA there is nothing to wait for: the
clocks are the host's.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def _cuda() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _sync() -> None:
    if _cuda():
        torch.cuda.synchronize()


@contextlib.contextmanager
def phase(name: str, sink=None):
    """Time a phase to the wall clock, finishing device work at both ends;
    prints "[gp_tpu_torch] name: s" or calls sink(name, seconds)."""
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        dt = time.perf_counter() - t0
        if sink is None:
            print(f"[gp_tpu_torch] {name}: {dt:.3f}s")
        else:
            sink(name, dt)


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler over the block, CPU and (where present) CUDA
    activity, exported to logdir/trace.json; yields the profiler
    (key_averages() sums the time by kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timer:
    """Accumulating phase timer: `with t("fit"): ...`; print(t) at the end.

    acc[name] is wall seconds (device work finished at both ends);
    device_ms[name] the milliseconds between CUDA events recorded on the
    current stream at the phase's ends, where the card is in use."""

    def __init__(self):
        self.acc = defaultdict(float)
        self.count = defaultdict(int)
        self.device_ms = defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        _sync()
        events = None
        if _cuda():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if events is not None:
                events[1].record()
            _sync()
            self.acc[name] += time.perf_counter() - t0
            self.count[name] += 1
            if events is not None:
                self.device_ms[name] += events[0].elapsed_time(events[1])

    def __str__(self):
        rows = [f"{k}: {v:.3f}s (x{self.count[k]})"
                for k, v in sorted(self.acc.items())]
        return "; ".join(rows) or "(no phases)"
