"""What the metric readers (metrics/<name>.py) share.  A reader returns
None where its run holds nothing for it to read."""

from __future__ import annotations

import re

from .roofline import PEAK_FLOPS


def per_unit(run, scale: float = 1.0):
    """The window's seconds over the units it completed."""
    return run.window_s / run.units * scale if run.units else None


def mean_span(run, name: str, scale: float = 1e3):
    s = run.spans.get(name)
    return sum(s) / len(s) * scale if s else None


def idle_share(run):
    """Per cent of the profiled segment in which nothing ran on the
    device."""
    seg = run.segment
    if not seg or seg["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - seg["busy_s"] / seg["window_s"])


def mfu(run, flops: float):
    """Per cent of the chip's peak that `flops` over the window is."""
    if not run.window_s or flops <= 0:
        return None
    return 100.0 * flops / run.window_s / PEAK_FLOPS[run.config["dtype"]]


def kernel_time(run, pattern: str):
    """(launches, device seconds) of the profiled kernels whose name
    matches `pattern`; None without a device trace or a match."""
    seg = run.segment
    if not seg:
        return None
    rx = re.compile(pattern)
    hits = [v for k, v in seg["kernels"].items() if rx.search(k)]
    if not hits:
        return None
    return sum(h[0] for h in hits), sum(h[1] for h in hits)
