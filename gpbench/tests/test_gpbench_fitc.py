"""The fitc family (families/fitc.py) and its cell, song330k_fitc: the
shrunk cell on the CPU reads correct, and each planted fault (a fit
capped at 40 evaluations, a steepest-descent optimizer) turns it false;
a configuration outside the family is refused before set-up; a run loads
no JAX; the traced run puts every device operation under a span; and, on
a card, K2 at the cell's (N, 512) x 90 in float64 against its plain form,
with its VJP against autograd of the plain form."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpbench import harness, program_trace
from gpbench.control import Capped, steepest_descent
from gpbench.harness import FORBIDDEN

from .shared import ROOT

CELL = "song330k_fitc"
# a few hundred rows of Song's width, 32 inducing rows, for the traced
# and refused runs
SMALL = {"config": {"n": 400, "m": 32},
         "traffic": {"heldout": 30, "pool": 2, "profile_evals": 6}}
# for the judged ones, 2000 rows and 256 inducing rows: enough that a
# sound fit descends as far a row as the cell's limits ask, and a capped
# one stops as far from a stationary point
JUDGED = {"config": {"n": 2000, "m": 256}, "traffic": SMALL["traffic"]}
# the per-layer metrics that read on the CPU (the others read the device)
NEW = {"kxu_ms", "nystrom_ms", "grad_ms.fitc", "fit_mfu.fitc",
       "evals_per_fit.fitc", "factor_ms.fitc", "syncs_per_eval.fitc",
       "optimizer_idle_ms.fitc"}


def _line(trace=False, program=None, seed=2 ** 31 + 5, size=JUDGED):
    return harness.run(ROOT, CELL, seed, 0.2, trace, "cpu", program=program,
                       overrides={k: dict(v) for k, v in size.items()})


def test_the_shrunk_cell_is_correct():
    line = _line()
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"nll", "grad", "stall", "pgrad", "mu",
                                   "s2"}
    assert line["attempted"] >= 3 and line["failed"] == 0


def test_the_program_and_the_reference_see_the_same_rows():
    """families/fitc.py mixes make_data's rows once, by one map, for the
    model's rows, its inducing rows, its predictions and the reference;
    the map is diag(s) Q, its singular values 1 and rows.weak."""
    from gpbench.synth import make_data
    _, _, config, _, _ = harness.resolve(ROOT, CELL)
    config.update(SMALL["config"])
    fam = harness.family(ROOT, "song_330k_fitc", config, "fit")
    X, y = make_data(config["n"] + 5, config["d"], 3)
    want = fam.rows(X, config)
    sv = np.linalg.svd(fam.mixing(config), compute_uv=False)
    assert np.allclose(sorted(set(np.round(sv, 12))),
                       [config["rows"]["weak"], 1.0])
    m = fam.model("fit", X, y, config, torch.float64, "cpu")
    assert np.array_equal(m.gp.train_in.numpy(), want)
    assert np.array_equal(m.gp.inducing.numpy(), want[-config["m"]:])
    got = fam.Reference(config)._rows(torch.as_tensor(X))
    assert np.array_equal(got.numpy(), want)


def _over(line, name):
    c = line["checks"][name]
    return c["value"] > c["limit"]


def test_a_capped_fit_turns_it_false():
    """Fits stopped at 40 evaluations end far from a stationary point:
    pgrad."""
    line = _line(program=Capped)
    assert not line["correct"] and _over(line, "pgrad")


def test_steepest_descent_turns_it_false():
    """The optimizer's L-BFGS direction replaced by -g: from the library's
    start the gradient is nearly all in sf, sn and the mean, and the fit
    barely descends: stall."""
    with steepest_descent():
        line = _line()
    assert not line["correct"] and _over(line, "stall")


def test_the_traced_run_reads_the_spans():
    line = _line(trace=True, size=SMALL)
    got = line["metrics"]
    # no CUDA kernel on the CPU: k2_roofline finds nothing to read
    assert NEW <= set(got) and "k2_roofline.fitc" not in got
    assert all(got[k]["value"] > 0 for k in NEW)


def test_device_time_by_span_sums_to_the_busy_time():
    run = harness.Run(CELL, {}, {}, {}, 0, 0.0, True, torch.device("cpu"))
    _, _, config, traffic, _ = harness.resolve(ROOT, CELL)
    config.update(SMALL["config"])
    traffic.update(SMALL["traffic"])
    run.config, run.traffic = config, traffic
    run.family = harness.family(ROOT, "song_330k_fitc", config, "fit")
    p = program_trace.program(run)
    assert p["device_s"].get(program_trace.NO_SPAN, 0.0) == 0.0
    assert sum(p["device_s"].values()) == pytest.approx(p["busy_s"])
    assert program_trace.n_spans(p, "objective") > 1
    assert p["counters"]["host_sync.sparse_set_k"] == 1
    assert {"train/objective/objective.kxu",
            "train/objective/objective.nystrom",
            "train/objective/objective.factor",
            "train/objective/objective.grad",
            "train/posterior"} <= set(p["spans"])


def _refused(tmp_path, config=None, traffic=None):
    shutil.copytree(ROOT / "gpbench", tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = tmp_path / "gpbench" / "configs" / "song_330k_fitc.json"
    cfg.write_text(json.dumps({**json.loads(cfg.read_text()),
                               **(config or {})}))
    if traffic:
        for c in m["workloads"]:
            if c["name"] == CELL:
                c["traffic"] = traffic
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    return subprocess.run(
        [sys.executable, "-m", "gpbench", "--workload", CELL, "--seed", "3",
         "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)


@pytest.mark.parametrize("change", [{"config": {"kernel": "matern52"}},
                                    {"traffic": "bo_64x2048"}],
                         ids=["kernel", "bo"])
def test_outside_the_family_is_refused_before_set_up(tmp_path, change):
    out = _refused(tmp_path, **change)
    assert out.returncode == 2 and "no result" in out.stderr
    assert "fitc" in out.stderr and out.stdout == ""


CHILD = """
import json, sys
from gpbench import harness
harness.run(".", "{cell}", 11, 0.2, True, "cpu",
            overrides=json.loads(sys.argv[1]))
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", CHILD.format(cell=CELL),
                          json.dumps(SMALL)], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "gp_tpu_torch" in loaded and not loaded & set(FORBIDDEN)


@pytest.mark.cuda
def test_k2_at_the_cells_shape_and_its_vjp():
    """K2 at (329820, 512) x 90 in float64, the cell's Kxu, within each
    entry's rounding bound of the plain form; its closed-form VJP within
    float64 rounding of autograd through the plain form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from gp_tpu_torch.ops import se_tile
    from gpbench.synth import make_data
    X, _ = make_data(329820, 90, (1, 5, 0))
    x = torch.as_tensor(X, device="cuda")
    u = x[-512:]
    # length scales at which the build's values spread over (0, sf2]
    chyp = torch.cat([torch.full((90,), 2.0, dtype=x.dtype, device="cuda"),
                      torch.tensor([0.1], dtype=x.dtype, device="cuda")])
    inv_l, sf2 = torch.exp(-chyp[:90]), torch.exp(2 * chyp[90])
    K = se_tile.se_matrix(inv_l, sf2, x, u)
    P = se_tile.se_matrix_plain(inv_l, sf2, x, u)
    err = (K - P).abs() / se_tile.rounding_bound(inv_l, sf2, x, u, P)
    print(f"\nK2 (329820, 512) x 90 f64: max |K - plain| / bound "
          f"{float(err.max()):.3f}, K in [{float(K.min()):.3e}, "
          f"{float(K.max()):.3e}]")
    assert bool((err <= 1.0).all())
    del K, P, err
    G = torch.randn(329820, 512, dtype=x.dtype, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    c = chyp.clone().requires_grad_(True)
    g, = torch.autograd.grad((se_tile.seard_k(c, x, u) * G).sum(), c)
    c2 = chyp.clone().requires_grad_(True)
    inv = torch.exp(-c2[:90])
    P = se_tile.se_matrix_plain(inv, torch.exp(2 * c2[90]), x, u)
    g_ref, = torch.autograd.grad((P * G).sum(), c2)
    rel = float((g - g_ref).abs().max() / g_ref.abs().max())
    print(f"K2 VJP vs autograd of the plain form: {rel:.3e} of the largest")
    assert rel <= 1e-10
