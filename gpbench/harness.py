"""One run of one cell: resolve the cell from BENCHMARK.json and the files
it names, set up, measure the window, judge the answers, read the metrics
and build the result line.

Everything a cell needs is found by name under the benchmark's directory
(`root`/gpbench by default):

  configs/<config>.json   sizes, dtype, fixed hyperparameters, source,
                          the model "family" and its "kernel";
  families/<family>.py    the family's program side, plain reference and
                          operation counts (families/exact.py);
  traffic/<traffic>.json  "kind" (a loop of loops.KINDS) and its
                          parameters;
  cells/<workload>.json   the limits of the numbers that decide `correct`;
  metrics/<metric>.py     one reader per metric, end-to-end or per-layer:
                          read(run) -> float, or None where it finds
                          nothing to read.

A new cell is a workloads entry in BENCHMARK.json and, where it needs
them, new files of these kinds: no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import trace as tracing
from .loops import KINDS

PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gp_tpu")


class Refused(Exception):
    """A cell that cannot be run as written: the command exits 2, before
    set-up, with no result."""


@dataclass
class Run:
    """What a run measured: the readers' input."""
    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    family: object = None
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0
    attempted: int = 0
    failed: int = 0
    unit_s: list = field(default_factory=list)
    counters: dict = field(default_factory=lambda: defaultdict(list))
    spans: dict = field(default_factory=dict)
    segment: dict | None = None
    answers: list = field(default_factory=list)

    @staticmethod
    def log(msg: str) -> None:
        print(f"[gpbench] {msg}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_dir(root: Path) -> Path:
    return Path(root) / "gpbench"


def resolve(root: Path, workload: str, manifest: dict | None = None):
    """(manifest, cell, config, traffic, limits) of one workload."""
    manifest = manifest or load_json(Path(root) / "BENCHMARK.json")
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"gpbench: no workload {workload!r} in "
                         f"BENCHMARK.json ({', '.join(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(Path(root) / configs[cell["config"]]["file"])
    b = bench_dir(root)
    traffic = load_json(b / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(b / "cells" / f"{workload}.json")["limits"]
    return manifest, cell, config, traffic, limits


def family(root: Path, config_name: str, config: dict, kind=None):
    """families/<config["family"]>.py, loaded; Refused where the config
    names no family or one that is not there, or a kernel that the
    family's reference does not compute, or (`kind` given) where the
    family does not serve that traffic kind."""
    name = config.get("family")
    path = bench_dir(root) / "families" / f"{name}.py"
    if not (isinstance(name, str) and name.isidentifier() and path.exists()):
        raise Refused(f"config {config_name}: no model family {name!r} "
                      f"(families/<family>.py)")
    fam = _load(path, f"gpbench_family_{name}")
    kernel = config.get("kernel")
    if kernel not in fam.KERNELS:
        raise Refused(f"config {config_name}: family {name} has no "
                      f"reference for kernel {kernel!r} (it computes "
                      f"{', '.join(fam.KERNELS)})")
    if kind is not None and kind not in fam.KINDS:
        raise Refused(f"config {config_name}: family {name} does not serve "
                      f"traffic of kind {kind!r} (it serves "
                      f"{', '.join(fam.KINDS)})")
    return fam


def _load(path: Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, workload: str, trace: bool) -> list:
    """The metrics entries a run of `workload` reports: with trace the
    per-layer ones, else the end-to-end ones.  An entry without
    "workloads" belongs to every cell (a per-layer one: every cell that
    reports the metric it moves)."""
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(root: Path, name: str):
    """metrics/<name>.py's read, or, where there is none, the file of the
    name's first part: idle_share.fit and idle_share.bo share
    metrics/idle_share.py."""
    path = bench_dir(root) / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(f"{name.split('.', 1)[0]}.py")
    return _load(path, f"gpbench_metric_{name.replace('.', '_')}").read


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run(root, workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_start=None, program=None, overrides=None) -> dict:
    """One run; returns the result line (a dict).  `program(family,
    config, device, spans)` builds the system under test (program.Port by
    default; the control and the tests put another in its place).
    `overrides` merges {"config": {...}, "traffic": {...}} into the
    files' values (the tests shrink a cell so).  Refused, before set-up,
    where the cell cannot run as written (family())."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest, cell, config, traffic, limits = resolve(root, workload)
    for key, part in (overrides or {}).items():
        {"config": config, "traffic": traffic}[key].update(part)
    fam = family(root, cell["config"], config, traffic["kind"])
    device = torch.device(device)
    r = Run(workload, cell, config, traffic, int(seed), float(seconds),
            bool(trace), device, fam)
    if program is None:
        from .program import Port as program
    from .program import NO_SPANS, Spans
    spans = Spans() if trace else NO_SPANS
    prog = program(fam, config, device, spans)
    loop = KINDS[traffic["kind"]](r, prog)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    loop.setup()
    r.setup_s = time.perf_counter() - t_start
    loop.window()
    r.spans = {k: list(v) for k, v in spans.seconds.items()}
    if trace:
        seg = tracing.Segment(device)
        loop.profile(seg)
        r.segment = seg.result
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    loop.close()
    checks = {}
    for name, value in loop.judge(device).items():
        checks[name] = {"value": value, "limit": limits[name]}
    judged = len(r.answers)
    correct = (r.failed == 0 and judged > 0 and set(checks) == set(limits)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values()))
    metrics = {}
    for m in cell_metrics(manifest, workload, trace):
        value = reader(root, m["name"])(r)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   f"nothing")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if trace and r.segment:
        dev["busy_s"] = r.segment["busy_s"]
        dev["window_s"] = r.segment["window_s"]
    line = {"correct": bool(correct), "attempted": r.attempted,
            "failed": r.failed, "metrics": metrics, "device": dev}
    if trace and r.segment:
        line["breakdown"] = tracing.breakdown(r.segment)
    line["checks"] = checks
    return line
