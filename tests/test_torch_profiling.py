"""The program's tracer (gp_tpu_torch/utils/profiling.py) on the CPU in
float64: off it records nothing, on it nests spans, counts and reads, and
takes the kernel wrappers' launch deltas; the spans sit where the
objective, absorb, the predictions and FITC's objective and posterior do
their work."""

import numpy as np
import pytest
import torch

from gp_tpu_torch import FITC, GP, BucketedGP
from gp_tpu_torch.models import fitc
from gp_tpu_torch.ops import chol_block, se_tile
from gp_tpu_torch.utils import profiling


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, (n, 3))
    return X, np.sin(3.0 * X[:, 0]) + 0.1 * rng.standard_normal(n)


def _names(t):
    return [s[0] for s in t.spans]


def _n(t, name):
    return _names(t).count(name)


def test_off_records_nothing_and_span_is_one_shared_object():
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        profiling.count("c")
        assert profiling.host_read(torch.tensor(True), "s") is True
    with profiling.tracing() as t:
        pass
    assert profiling.span("a") is profiling.span("b")
    with profiling.span("a"):
        profiling.count("c")
    assert not t.spans and not t.counters and not t.launches


def test_spans_nest_counters_count_and_reads_count_by_site():
    with profiling.tracing() as t:
        with pytest.raises(RuntimeError):
            with profiling.tracing():
                pass
        with profiling.span("outer"):
            with profiling.span("inner"):
                profiling.count("c")
                profiling.count("c", 2)
            with profiling.span("inner"):
                v = profiling.host_read(torch.tensor(2.5), "x")
                b = profiling.host_read(torch.tensor(1.0) > 0, "y")
        profiling.host_read(torch.tensor(False), "y")
    assert (v, b) == (2.5, True) and type(v) is float and type(b) is bool
    assert _names(t) == ["outer", "inner", "inner"]
    assert [s[1] for s in t.spans] == [-1, 0, 0]
    assert [t.path(i) for i in range(3)] == ["outer", "outer/inner",
                                             "outer/inner"]
    (_, _, b0, e0), (_, _, b1, e1), (_, _, b2, e2) = t.spans
    assert b0 <= b1 <= e1 <= b2 <= e2 <= e0
    assert _n(t, "inner") == 2
    assert dict(t.counters) == {"c": 3, "host_sync.x": 1, "host_sync.y": 2}


def test_launch_deltas_over_the_extent():
    with profiling.tracing() as t:
        se_tile.launches["se_matrix_diag"]["se"] += 3
        chol_block.launches["chol_inv_reg"] += 64
    se_tile.launches["se_matrix_diag"]["se"] -= 3
    chol_block.launches["chol_inv_reg"] -= 64
    assert t.launches == {"se_tile.se_matrix_diag.se": 3,
                          "chol_block.chol_inv_reg": 64}


def test_fit_has_an_objective_span_per_evaluation_with_its_stages():
    X, y = _data(64)
    gp = GP(X, y, device="cpu")
    with profiling.tracing() as t:
        gp.train()
    evals = gp.last_opt_result.evals
    objective = [i for i, s in enumerate(t.spans) if s[0] == "objective"]
    assert len(objective) == evals > 1
    for i in objective:
        _, parent, b, e = t.spans[i]
        assert t.spans[parent][0] == "train"
        kids = [s for s in t.spans if s[1] == i]
        assert [s[0] for s in kids] == ["objective.factor",
                                        "objective.inverse",
                                        "objective.grad"]
        assert all(b <= s[2] <= s[3] <= e for s in kids)
    assert _n(t, "train") == _n(t, "posterior") == 1 and _n(t, "nll") >= 1
    reads = {k: v for k, v in t.counters.items() if k.startswith("host_sync")}
    assert reads["host_sync.lbfgsb.armijo"] == evals - 1


def test_bucketed_absorb_and_acquisition_spans_and_the_refactor_counter():
    X, y = _data(52, 1)
    bo = BucketedGP(X[:40], y[:40], bucket=8, device="cpu")
    bo.set_fixed(True)
    bo.train(init_hyps=bo.get_default_hyps())
    assert bo.capacity == 40
    with profiling.tracing() as t:
        for i in range(40, 52):
            bo.batch_predict_y_with_grad(X[:5])
            bo.batch_predict_s2_with_grad(X[:5])
            bo.absorb(X[i], y[i])
        bo.batch_predict(X[:5])
    # the buffer was full at 40 and 48 rows: two refactorizations, ten
    # appends with their solve
    assert t.counters["fallback.absorb_refactor"] == 2
    assert _n(t, "absorb") == 12 and _n(t, "absorb.solve") == 10
    paths = {t.path(i) for i in range(len(t.spans))}
    assert {"absorb/absorb.solve", "absorb/posterior",
            "predict.mean_grad/predict.backward",
            "predict.var_grad/predict.solve",
            "predict.var_grad/predict.backward",
            "predict/predict.solve"} == paths - {
                "absorb", "predict", "predict.mean_grad", "predict.var_grad"}
    assert _n(t, "predict.var_grad") == 12 and _n(t, "predict") == 1


def _fitc(n=90, m=16):
    X, y = _data(n, 2)
    gp = FITC(X, y, device="cpu")
    gp.set_inducing(X[-m:])
    return gp


def test_fitc_evaluation_spans_and_one_set_k_read():
    gp = _fitc()
    gp._MAX_EVAL = 6
    gp.train()                      # tracer off: nothing to record into
    with profiling.tracing() as t:
        pass
    gp.train()
    assert not t.spans and not t.counters
    with profiling.tracing() as t:
        gp.train()
    evals = gp.last_opt_result.evals
    objective = [i for i, s in enumerate(t.spans) if s[0] == "objective"]
    assert len(objective) == evals > 1
    for i in objective:
        _, parent, b, e = t.spans[i]
        assert t.spans[parent][0] == "train"
        kids = [s for s in t.spans if s[1] == i]
        assert [s[0] for s in kids] == [
            "objective.kxu", "objective.factor", "objective.nystrom",
            "objective.factor", "objective.grad"]
        assert all(b <= s[2] <= s[3] <= e for s in kids)
    assert _n(t, "train") == _n(t, "posterior") == 1
    # the start and final nll() run the same stages under "nll"
    assert {t.path(i) for i in range(len(t.spans))
            if t.spans[i][0] == "objective.kxu"} == {
                "train/objective/objective.kxu", "train/nll/objective.kxu"}
    assert t.counters["host_sync.sparse_set_k"] == 1


def test_fitc_set_k_reads_once_a_try(monkeypatch):
    gp = _fitc()
    calls = []
    real = fitc.chol_ok

    def failing_twice(L):
        calls.append(1)
        return real(L) & (len(calls) > 4)   # two calls a try
    monkeypatch.setattr(fitc, "chol_ok", failing_twice)
    gp.set_fixed(True)
    with profiling.tracing() as t:
        gp.train(init_hyps=gp.get_default_hyps())
    assert t.counters["host_sync.sparse_set_k"] == 3
    assert gp._jitter_u == 4 * (0.1 * 1e-3) ** 2
