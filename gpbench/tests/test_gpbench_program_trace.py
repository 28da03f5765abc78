"""The program's spans over the device trace (program_trace.py): the two
attributions on a hand-made trace, the shrunk cells' traced and untraced
lines against a manifest without the program's metrics, a program with no
tracer, and, on a card, the clock that the spans and the profiler share."""

import json
import math

import pytest
import torch

from gp_tpu_torch.models import exact
from gp_tpu_torch.utils.profiling import Trace
from gpbench import harness, program_trace
from gpbench.program_trace import NO_SPAN, ProgramSegment, reduce, work

from .shared import ROOT, STREAM_MIN_N, small

NEW = {"bundled8k_fit": {"factor_ms", "inverse_ms", "grad_ms",
                         "syncs_per_eval", "optimizer_idle_ms"},
       "bundled8k_bo": {"absorb_solve_ms", "acq_solve_ms", "acq_backward_ms",
                        "acq_idle_ms"},
       "stream51k_predict": {"predict_factor_ms"}}
AT_LEAST_ZERO = {"syncs_per_eval", "optimizer_idle_ms", "acq_idle_ms"}


def test_ops_go_to_the_span_open_at_their_launch_and_gaps_to_midpoints():
    us = 1000
    trace = Trace(spans=[["a", -1, 0, 1000 * us], ["b", 0, 100 * us, 200 * us],
                         ["b", 0, 300 * us, 400 * us]], counters={"c": 1})
    ops = [(50 * us, 60 * us, 120 * us, "k1"),     # launched under a
           (150 * us, 150 * us, 250 * us, "k2"),   # under a/b, runs past it
           (350 * us, 390 * us, 395 * us, "k3"),   # a/b
           (1100 * us, 1100 * us, 1110 * us, "k4"),  # after a: no span
           (1200 * us, 1205 * us, 1210 * us, "k5"),
           (1211 * us, 1215 * us, 1220 * us, "k6")]
    p = reduce(ops, trace, 1.0)
    assert p["spans"] == {"a": 1, "a/b": 2}
    assert p["device_s"] == pytest.approx({"a": 60e-6, "a/b": 105e-6,
                                           NO_SPAN: 20e-6})
    # gaps by midpoint: 120-150 (135: a/b), 250-390 (320: a/b), 395-1100
    # (747: a), 1110-1205 (no span); 1210-1215 is under 20 us
    assert p["idle_s"] == pytest.approx({"a/b": 170e-6, "a": 705e-6,
                                         NO_SPAN: 95e-6})
    assert p["short_idle_s"] == pytest.approx(5e-6)
    assert p["busy_s"] == pytest.approx(185e-6) and p["counters"] == {"c": 1}


def _line(root, workload, trace):
    return harness.run(root, workload, 2 ** 31 + 5, 0.2, trace, "cpu",
                       overrides=small(workload))


@pytest.fixture(scope="module")
def parent_root(tmp_path_factory):
    """A root whose manifest lacks the program's metrics (the benchmark's
    files otherwise the same)."""
    root = tmp_path_factory.mktemp("parent")
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    gone = set().union(*NEW.values())
    m["per_layer"] = [e for e in m["per_layer"] if e["name"] not in gone]
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    (root / "gpbench").symlink_to(ROOT / "gpbench")
    return root


@pytest.mark.parametrize("workload", sorted(NEW))
def test_traced_cells_add_the_program_metrics_and_keep_the_rest(
        workload, parent_root, monkeypatch):
    if workload.startswith("stream"):
        # the shrunk cell's rows are the factor-free posterior's, as at
        # N = 51200
        monkeypatch.setattr(exact, "_STREAM_MIN_N", STREAM_MIN_N)
    traced = _line(ROOT, workload, True)["metrics"]
    before = _line(parent_root, workload, True)["metrics"]
    assert set(traced) == set(before) | NEW[workload]
    for name in NEW[workload]:
        v = traced[name]["value"]
        assert math.isfinite(v) and (v >= 0 if name in AT_LEAST_ZERO
                                     else v > 0), name
    old = json.loads((parent_root / "BENCHMARK.json").read_text())
    assert set(_line(ROOT, workload, False)["metrics"]) == {
        m["name"] for m in harness.cell_metrics(old, workload, False)}


def test_a_program_without_the_tracer_reports_none(monkeypatch):
    monkeypatch.setattr(program_trace.TracedPort, "tracer", lambda self: None)
    got = set(_line(ROOT, "bundled8k_bo", True)["metrics"])
    assert {"absorb_ms", "acq_ms"} <= got and not got & NEW["bundled8k_bo"]


@pytest.mark.cuda
def test_a_span_holds_its_k1_launch_on_the_profilers_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gp_tpu_torch.ops import se_tile
    from gp_tpu_torch.utils import profiling
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2048, 10, generator=g).cuda()
    inv_l = torch.full((10,), 0.7, device="cuda")
    sf2 = torch.tensor(1.3, device="cuda")
    dvals = torch.full((2048,), 1.4, device="cuda")
    se_tile.se_matrix_diag(inv_l, sf2, x, dvals)
    torch.cuda.synchronize()
    seg = ProgramSegment("cuda", profiling.tracing)
    seg.start()
    with profiling.span("before"):
        x @ x.T
    with profiling.span("k1"):
        se_tile.se_matrix_diag(inv_l, sf2, x, dvals)
    with profiling.span("after"):
        x @ x.T
    seg.stop()
    (_, _, b, e), = [s for s in seg.trace.spans if s[0] == "k1"]
    k1, = [ev for ev in seg.events if "se_tile<" in ev.name()]
    call, = [ev for ev in seg.events if program_trace._on_host(ev)
             and ev.correlation_id() == k1.correlation_id()]
    c0, c1 = call.start_ns(), call.start_ns() + call.duration_ns()
    print(f"\nk1 span [{b}, {e}] ns: its launch call opens {c0 - b} ns after "
          f"the span and closes {e - c1} ns before it ends")
    assert b <= c0 <= c1 <= e
    # K1's kernel is put down to "k1" and to no other span
    ops = work(seg.events, True)
    mine = [w for w in ops if b <= w[0] <= e]
    assert any(w[3] == k1.name() for w in mine)
    assert not any(w[3] == k1.name() for w in ops if w not in mine)
    assert seg.result["device_s"]["k1"] == pytest.approx(
        sum((w[2] - w[1]) * 1e-9 for w in mine))
