"""Model families (families/<family>.py): a family added from files alone,
the cells refused before set-up, the exact family's calls into the
program against the parent's Port, and the operation counts that the MFU
readers divide by."""

import inspect
import json
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpbench import harness, loops
from gpbench.program import Port
from gpbench.roofline import PEAK_FLOPS

from .shared import ROOT, STREAM_MIN_N, SMALL, small

# a family of files alone: the exact GP with the isotropic SE kernel; its
# reference is the exact one at one length scale repeated over the inputs
TOY = '''"""The exact GP, isotropic SE (a test's family)."""
import torch

from gpbench import roofline
from gpbench.reference import gp

KERNELS = ("se_iso",)
KINDS = ("fit", "predict")


def model(kind, X, y, config, dtype, device):
    from gp_tpu_torch import GP
    return GP(X, y, kernel=config["kernel"], dtype=dtype, device=device)


def _one_to_each(v, d):
    return torch.cat([v[:1].expand(d), v[1:]])


def _first_of_d(v, d, pick):
    return torch.cat([pick(v[:d])[None], v[d:]])


class Reference:
    standardized = staticmethod(gp.standardized)
    to_standardized = staticmethod(gp.to_standardized)
    from_standardized = staticmethod(gp.from_standardized)
    projected_gradient = staticmethod(gp.projected_gradient)

    def __init__(self, config):
        self.d = config["d"]

    def nll(self, x, y, hyp, prec):
        return gp.nll(x, y, _one_to_each(hyp, self.d), prec)

    def nll_grad(self, x, ys, v, prec):
        f, g = gp.nll_grad(x, ys, _one_to_each(v, self.d), prec)
        return f, _first_of_d(g, self.d, torch.sum)

    def default_hyp(self, x, y):
        h = gp.default_hyp(x, y)
        return torch.cat([torch.zeros_like(h[:1]), h[self.d:]])

    def hyp_bounds(self, x, y):
        lb, ub = gp.hyp_bounds(x, y)
        return (_first_of_d(lb, self.d, torch.max),
                _first_of_d(ub, self.d, torch.min))

    def posterior(self, x, y, hyp, prec):
        return (x, *gp.posterior(x, y, _one_to_each(hyp, self.d), prec))

    def predict(self, post, xs, prec):
        return gp.predict(*post, xs, prec)


def fit_eval_flops(config):
    return roofline.fit_eval_flops(config["n"], 1)


def predict_request_flops(config, rows):
    return roofline.predict_request_flops(config["n"], 1, rows,
                                          refactors=False)
'''
TOY_CONFIG = {"family": "exact_iso", "kernel": "se_iso", "n": 60, "d": 8,
              "dtype": "float64", "hyp": [0.4, 0.1, -1.5, 0.05]}


def _bench_copy(tmp_path):
    """The benchmark under tmp_path, with the toy family and its config,
    and a manifest to edit."""
    shutil.copytree(ROOT / "gpbench", tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    g = tmp_path / "gpbench"
    (g / "families" / "exact_iso.py").write_text(TOY)
    (g / "configs" / "toy.json").write_text(json.dumps(TOY_CONFIG))
    return json.loads((ROOT / "BENCHMARK.json").read_text()), g


def _add(m, name, config, traffic, e2e, per_layer=()):
    m["workloads"].append({"name": name, "config": config,
                           "traffic": traffic, "chips": 1, "why": "a test's"})
    for e in m["end_to_end"] + m["per_layer"]:
        if e["name"] in (e2e, *per_layer):
            e["workloads"].append(name)


def test_a_family_added_from_files_alone(tmp_path):
    m, g = _bench_copy(tmp_path)
    m["configs"].append({"name": "toy", "source": "https://example.org",
                         "file": "gpbench/configs/toy.json", "reduced": [],
                         "why": "a test's"})
    m["end_to_end"][0].pop("workloads", None)
    _add(m, "toy.fit", "toy", "quick_fits", "fit_s",
         ("fit_mfu", "factor_ms"))
    _add(m, "toy.predict", "toy", "quick_requests", "predict_s",
         ("predict_mfu",))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    (g / "traffic" / "quick_fits.json").write_text(json.dumps(
        {"kind": "fit", "pool": 2, "pool_seed": 1, "heldout": 10,
         "warm_evals": 2, "profile_evals": 4}))
    (g / "traffic" / "quick_requests.json").write_text(json.dumps(
        {"kind": "predict", "rows": 7}))
    (g / "cells" / "toy.fit.json").write_text(json.dumps(
        {"limits": {"nll": 1e-8, "grad": 1e-8, "stall": 0.0, "pgrad": 1e-2,
                    "mu": 1e-8, "s2": 1e-8}}))
    (g / "cells" / "toy.predict.json").write_text(json.dumps(
        {"limits": {"mu": 1e-8, "s2": 1e-8}}))
    for trace in (False, True):
        fit = harness.run(tmp_path, "toy.fit", 3, 0.2, trace, "cpu")
        assert fit["correct"], fit["checks"]
        got = harness.run(tmp_path, "toy.predict", 3, 0.2, trace, "cpu")
        assert got["correct"] and got["attempted"] > 0, got["checks"]
    assert {"fit_mfu", "factor_ms"} <= set(fit["metrics"])
    assert set(got["metrics"]) == {"predict_mfu"}


REFUSED = {
    "no_family": ("bundled8k_fit", {"family": None}, "no model family None"),
    "unknown_family": ("bundled8k_fit", {"family": "fitc_nonesuch"},
                       "no model family 'fitc_nonesuch'"),
    "kernel": ("stream51k_predict", {"kernel": "matern52"},
               "no reference for kernel 'matern52'"),
    "kind": ("bundled8k_bo", {"family": "exact_iso", "kernel": "se_iso"},
             "does not serve traffic of kind 'bo'"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_a_cell_that_cannot_run_is_refused_before_setup(tmp_path, case):
    workload, config, said = REFUSED[case]
    _bench_copy(tmp_path)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    built = []
    with pytest.raises(harness.Refused) as exc:
        harness.run(tmp_path, workload, 1, 0.2, False, "cpu",
                    program=lambda *a: built.append(a),
                    overrides={"config": config})
    config_name = harness.resolve(tmp_path, workload)[1]["config"]
    assert str(exc.value).startswith(f"config {config_name}: ")
    assert said in str(exc.value) and not built


@pytest.mark.parametrize("case", ["unknown_family", "kernel", "kind"])
def test_the_command_exits_2_with_no_result(tmp_path, case):
    workload, config, said = REFUSED[case]
    _, g = _bench_copy(tmp_path)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    name = harness.resolve(tmp_path, workload)[1]["config"]
    path = g / "configs" / f"{name}.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **config}))
    out = subprocess.run(
        [sys.executable, "-m", "gpbench", "--workload", workload, "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert f"config {name}: " in out.stderr and said in out.stderr


# -- the exact family makes the parent's calls into the program ----------

class ParentPort(Port):
    """The parent's Port, whose methods built the exact GP themselves:
    these three are its own, as they were, but that the dtype and the
    bucket come from the configuration (its other methods are
    unchanged)."""

    def fit(self, X, y, Xte, max_evals=None, segment=None) -> dict:
        from gp_tpu_torch import GP

        from gpbench.program import _np
        gp = GP(X, y, dtype=self.dtype, device=self.device)
        if max_evals is not None:
            gp._MAX_EVAL = max_evals
        self.model = gp
        if segment is not None:
            segment.start()
        nll = gp.train()
        if segment is not None:
            segment.stop()
        mu, s2 = gp.batch_predict(Xte)
        res = gp.last_opt_result
        out = {"nll": float(nll), "hyp": _np(torch.as_tensor(gp.get_hyp())),
               "x": _np(res.x), "g": _np(res.g), "evals": int(res.evals),
               "mu": _np(mu), "s2": _np(s2)}
        self.model = None
        return out

    def serve_setup(self, X, y, hyp) -> None:
        from gp_tpu_torch import GP
        gp = GP(X, y, dtype=self.dtype, device=self.device)
        gp.set_fixed(True)
        gp.train(init_hyps=np.asarray(hyp, np.float64))
        self.model = gp

    def bo_build(self, X, y, hyp) -> None:
        from gp_tpu_torch import BucketedGP
        self.model = None
        bo = BucketedGP(X, y, bucket=self.config["bucket"], dtype=self.dtype,
                        device=self.device)
        bo.set_fixed(True)
        bo.train(init_hyps=np.asarray(hyp, np.float64))
        self.model = bo


METHODS = ("set_fixed", "train", "batch_predict", "get_hyp",
           "batch_predict_y_with_grad", "batch_predict_s2_with_grad",
           "absorb")


def _norm(v):
    """A value as the log compares it: arrays and tensors by their
    shape, dtype and bytes."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return ("array", v.shape, str(v.dtype), hash(v.tobytes()))
    if isinstance(v, dict):
        return tuple(sorted((k, _norm(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_norm(x) for x in v)
    if isinstance(v, (torch.dtype, torch.device)):
        return str(v)
    return v


def _arguments(cls, a, k):
    """A constructor's arguments, its defaults filled in; BucketedGP's
    **kw bound as GP's."""
    import gp_tpu_torch.models.exact as ex
    bound = inspect.signature(cls.__init__).bind(None, *a, **k)
    bound.apply_defaults()
    out = dict(bound.arguments)
    out.pop("self")
    rest = out.pop("kw", None)
    if rest is not None:
        out.update(_arguments(ex.GP, (out["train_x"], out["train_y"]), rest))
    return out


def _recording(cls, log):
    """`cls` that logs its construction, the calls of METHODS and the
    setting of the evaluation budget, and otherwise is `cls`."""
    def init(self, *a, **k):
        log.append((cls.__name__, _norm(_arguments(cls, a, k))))
        cls.__init__(self, *a, **k)

    def setattr_(self, name, value):
        if name == "_MAX_EVAL":
            log.append(("set", name, value))
        object.__setattr__(self, name, value)

    ns = {"__init__": init, "__setattr__": setattr_}
    for name in METHODS:
        def method(self, *a, _name=name, **k):
            log.append((_name, _norm(a), _norm(k)))
            return getattr(cls, _name)(self, *a, **k)
        ns[name] = method
    return type(cls.__name__, (cls,), ns)


# each loop's end after a fixed number of its checks, not a time: the fit
# cell one pass, the stream cell 3 requests, the BO cell 3 steps
CHECKS = {"bundled8k_fit": 0, "stream51k_predict": 2, "bundled8k_bo": 3}
CALLED = {"bundled8k_fit": {"GP", "set", "train", "batch_predict", "get_hyp"},
          "stream51k_predict": {"GP", "set_fixed", "train", "batch_predict"},
          "bundled8k_bo": {"BucketedGP", "set_fixed", "train",
                           "batch_predict_y_with_grad",
                           "batch_predict_s2_with_grad", "absorb"}}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_exact_family_makes_the_parents_calls(monkeypatch, workload):
    import gp_tpu_torch
    from gp_tpu_torch.models import exact
    monkeypatch.setattr(exact, "_STREAM_MIN_N", STREAM_MIN_N)
    log = []
    for cls in (gp_tpu_torch.GP, gp_tpu_torch.BucketedGP):
        monkeypatch.setattr(gp_tpu_torch, cls.__name__, _recording(cls, log))
    logs = []
    for program in (ParentPort, Port):
        checks = iter(range(10 ** 6))
        monkeypatch.setattr(loops._Loop, "_over", lambda self, t0: (
            next(checks) >= CHECKS[workload]))
        line = harness.run(ROOT, workload, 2 ** 31 + 9, 0.0, False, "cpu",
                           program=program, overrides=small(workload))
        assert line["correct"], line["checks"]
        logs.append(list(log))
        log.clear()
    parent, change = logs
    assert {c[0] for c in change} >= CALLED[workload]
    assert change == parent


# -- the counts ------------------------------------------------------------

def _family_of(config_name):
    config = harness.load_json(ROOT / "gpbench" / "configs"
                               / f"{config_name}.json")
    return harness.family(ROOT, config_name, config), config


def test_the_exact_counts_are_the_parents_at_the_cells_sizes():
    fam, c = _family_of("bundled_8k")
    n, d = c["n"], c["d"]
    assert fam.fit_eval_flops(c) == (n ** 3 + (2 * d + 5) * n ** 2
                                     + 4 * n ** 2 * (d + 1))
    fam, c = _family_of("stream_51k")
    n, d, m = c["n"], c["d"], 2000
    assert fam.predict_request_flops(c, m) == (
        n ** 3 / 3 + (2 * d + 5) * n ** 2 + (2 * d + 5) * m * n
        + 2 * m * n + n ** 2 * m)


def test_a_request_below_the_stream_regime_runs_no_factorization():
    fam, c = _family_of("bundled_8k")
    n, d, m = c["n"], c["d"], 2000
    assert n < fam.STREAM_MIN_N
    assert fam.predict_request_flops(c, m) == (
        (2 * d + 5) * m * n + 2 * m * n + n ** 2 * m)


def test_the_mfu_readers_divide_by_the_familys_count():
    fam = SimpleNamespace(fit_eval_flops=lambda c: 3e12,
                          predict_request_flops=lambda c, rows: rows * 1e11)
    run = SimpleNamespace(family=fam, config={"dtype": "float32"},
                          traffic={"rows": 20}, window_s=2.0, units=5,
                          counters={"evals": [3, 4]})
    peak = PEAK_FLOPS["float32"]
    assert harness.reader(ROOT, "fit_mfu")(run) == pytest.approx(
        100 * 7 * 3e12 / 2.0 / peak)
    assert harness.reader(ROOT, "predict_mfu")(run) == pytest.approx(
        100 * 5 * 20 * 1e11 / 2.0 / peak)
