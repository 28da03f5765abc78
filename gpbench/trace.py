"""The profiled segment of a --trace 1 run, reduced to what the per-layer
metrics read.

A `Segment` runs torch.profiler (the CUDA activity: kernels, copies and
the runtime calls that launched them) over a bounded piece of work that
the traffic kind chooses (loops.py), with the device's queue drained at
both ends, and keeps only the reduction:

  window_s   the segment's wall seconds (host clock);
  busy_s     the union of the intervals in which the device worked
             (kernels, copies, sets), in seconds;
  kernels    {name: [launches, device seconds]};
  gaps       {what the host was doing: idle seconds}: each gap between
             device intervals of 20 us or more is named by the CUDA
             runtime call open at its midpoint (a launch, a copy, a
             synchronize), "python" where none is: the host was running
             Python between calls; the shorter gaps are summed under
             "gaps under 20 us".

Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


GAP_NS = 20_000
SHORT_GAPS = "gaps under 20 us"


class Segment:
    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.result = None

    def start(self) -> None:
        # on the card the device's activity alone: recording every host op
        # as well doubles the host's cost of an evaluation, and the device
        # then idles for the profiler
        acts = [torch.profiler.ProfilerActivity.CUDA
                if self.device.type == "cuda"
                else torch.profiler.ProfilerActivity.CPU]
        sync(self.device)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        sync(self.device)
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        self.result = reduce(events, window_s)


def _on_host(e) -> bool:
    return str(e.device_type()).rsplit(".", 1)[-1] == "CPU"


def _device_work(e) -> bool:
    """A kernel, copy or set: a device event other than the ranges that
    record_function opens there (user annotations), which do no work."""
    if _on_host(e):
        return False
    annotation = getattr(e, "is_user_annotation", None)
    return not (annotation is not None and annotation())


def reduce(events, window_s: float) -> dict:
    dev, host = [], []
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if _device_work(e):
            dev.append((start, end, e.name()))
        elif _on_host(e):
            host.append((start, end, e.name()))
    kernels = defaultdict(lambda: [0, 0.0])
    for s, t, name in dev:
        k = kernels[name]
        k[0] += 1
        k[1] += (t - s) * 1e-9
    busy, gaps = 0, defaultdict(float)
    host.sort()
    starts = [h[0] for h in host]
    end = None
    for s, t, _ in sorted(dev):
        if end is None or s > end:
            if end is not None:
                gaps[_gap_label(host, starts, end, s)] += (s - end) * 1e-9
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return {"window_s": window_s, "busy_s": busy * 1e-9,
            "kernels": dict(kernels), "gaps": dict(gaps)}


def _gap_label(host, starts, a: int, b: int) -> str:
    if b - a < GAP_NS:
        return SHORT_GAPS
    mid = (a + b) // 2
    i = bisect.bisect_right(starts, mid)
    # the innermost open event is the latest-starting one that covers mid
    for j in range(i - 1, max(i - 400, 0) - 1, -1):
        if host[j][1] >= mid:
            return host[j][2]
    return "python"


def breakdown(result: dict, top: int = 10) -> dict:
    """The result line's breakdown: the device operations that took most
    time and the host activities under the most idle time."""
    ops = sorted(((name[:160], sec) for name, (_, sec)
                  in result["kernels"].items()), key=lambda r: -r[1])
    gaps = sorted(((name[:160], sec) for name, sec
                   in result["gaps"].items()), key=lambda r: -r[1])
    return {"device_ops": [list(r) for r in ops[:top]],
            "idle_gaps": [list(r) for r in gaps[:top]]}
