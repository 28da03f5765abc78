"""BENCHMARK.json against the benchmark's own rules, and a cell added
from files alone."""

import json
import re
import shutil

from gpbench import harness

from .shared import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
M = json.loads((ROOT / "BENCHMARK.json").read_text())
B = ROOT / "gpbench"


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "-m", "gpbench"]
    assert M["paths"] == ["gpbench"]
    assert 1 <= M["run_seconds"] <= 51


def test_names_units_and_keys():
    metrics = M["end_to_end"] + M["per_layer"]
    names = [x["name"] for x in M["configs"] + M["workloads"] + metrics]
    assert all(NAME.match(n) for n in names)
    assert len(set(n for n in names)) == len(names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for c in M["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["chips"] == 1 and len(c["why"]) <= 200
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpbench/configs/")


def test_every_name_finds_its_files():
    cells = {c["name"] for c in M["workloads"]}
    used = {c["config"] for c in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    for c in M["workloads"]:
        _, _, config, traffic, limits = harness.resolve(ROOT, c["name"], M)
        assert traffic["kind"] in harness.KINDS and limits
    for m in M["end_to_end"] + M["per_layer"]:
        assert callable(harness.reader(ROOT, m["name"]))
        assert set(m.get("workloads", cells)) <= cells


def test_each_cell_reports_setup_another_e2e_and_a_layer():
    for c in M["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(M, c["name"], False)}
        layer = harness.cell_metrics(M, c["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        # each per-layer metric moves an end-to-end metric of its cells
        assert all(m["moves"] in e2e for m in layer)


def test_a_cell_added_from_files_alone(tmp_path):
    shutil.copytree(B, tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny_fit", "source": "https://example.org",
                         "file": "gpbench/configs/tiny_fit.json",
                         "reduced": [], "why": "a throwaway"})
    m["workloads"].append({"name": "tiny_fit.quick", "config": "tiny_fit",
                           "traffic": "quick_fits", "chips": 1,
                           "why": "a throwaway"})
    m["end_to_end"][0].pop("workloads", None)
    m["per_layer"].append({"name": "tiny_evals", "unit": "evals",
                           "better": "lower", "source": "program_counter",
                           "layer": "optimizer (optim/lbfgsb.py)",
                           "moves": "fit_s",
                           "workloads": ["tiny_fit.quick"]})
    for e in m["end_to_end"]:
        if e["name"] == "fit_s":
            e["workloads"].append("tiny_fit.quick")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    g = tmp_path / "gpbench"
    (g / "configs" / "tiny_fit.json").write_text(json.dumps(
        {"family": "exact", "kernel": "se_ard", "n": 60, "d": 8,
         "dtype": "float64"}))
    (g / "traffic" / "quick_fits.json").write_text(json.dumps(
        {"kind": "fit", "pool": 2, "pool_seed": 1, "heldout": 10,
         "warm_evals": 2,
         "profile_evals": 4}))
    (g / "cells" / "tiny_fit.quick.json").write_text(json.dumps(
        {"limits": {"nll": 1e-8, "grad": 1e-8, "stall": 0.0, "pgrad": 1e-2,
                    "mu": 1e-8, "s2": 1e-8}}))
    (g / "metrics" / "tiny_evals.py").write_text(
        "def read(run):\n    return len(run.counters['evals'])\n")
    line = harness.run(tmp_path, "tiny_fit.quick", 3, 0.2, False, "cpu")
    assert line["correct"] and set(line["metrics"]) == {"setup_s", "fit_s"}
    line = harness.run(tmp_path, "tiny_fit.quick", 3, 0.2, True, "cpu")
    assert line["correct"] and "tiny_evals" in line["metrics"]
    assert list(line)[-1] == "checks"
