"""The port's FITC on a CUDA card against gp_tpu's own record of its FITC
fit, benchmarks/golden/tpu_fitc_n102400_m512.json: make_data(102400, 10,
seed=42), the last 512 rows inducing, float64, held out make_data(2000,
10, seed=7).

The record holds the TPU fit's hyperparameters, its final NLL
(-28998.207) and held-out RMSE (0.1687), and an independent float64
oracle's NLL at those hyperparameters (-28997.678): the TPU's own value
is oracle_rel_diff = 1.8e-5 (0.53 nats) of it off.

Why the port's train() ends far below the record: the record stopped
short of a stationary point.  By the float64 reference
(gpbench/reference/fitc.py, the whitened form), at the record's
hyperparameters the objective's gradient, projected on the library's
box, is 0.43 a row in the optimizer's units, five times what the port's
fit leaves; from there the objective keeps descending, by far more than
the record's own error.  gp_tpu's host-driven L-BFGS ends at the first
step that 25 halvings cannot make acceptable; there cond(A) + M sf2/sn2
is ~5e11, and FITC.cpp's form rounds its NLL to ~1e-4 of itself, the
order of the record's own 1.8e-5.  The port goes on (PERF.md).  The
tests hold those two facts, and the port's fit against them.  The
reference judges the points because at the port's fitted point that
scale is ~4e16, where FITC.cpp's form keeps no digit of the NLL (the
card's and the CPU's are 1.5 % apart).

Every test here is marked `cuda` and skips without a CUDA device; this
file imports neither jax nor gp_tpu:

    python -m pytest --noconftest -p no:cacheprovider -s \\
        tests/test_torch_fitc_golden.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gp_tpu_torch import FITC
from gp_tpu_torch.utils.synth import make_data
from gpbench.reference import fitc as ref
from gpbench.reference import gp as ref_gp
from test_torch_fitc_reference import _scale

pytestmark = pytest.mark.cuda

RECORD = (Path(__file__).resolve().parents[1] / "benchmarks" / "golden"
          / "tpu_fitc_n102400_m512.json")
EPS = float(np.finfo(np.float64).eps)
# a descent of this many of the record's own errors is no rounding
MARGIN = 100


@pytest.fixture(scope="module")
def data():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rec = json.loads(RECORD.read_text())
    X, y = make_data(102400, 10, seed=42)
    return rec, X, y


def _model(X, y):
    gp = FITC(X, y, device="cuda")
    gp.set_inducing(X[-512:])
    return gp


def _reference(X, y, hyp):
    """(NLL, projected gradient a row) of the float64 reference at hyp,
    with the library's jitter: the gradient in the optimizer's
    standardized units, projected on the library's box, as the
    benchmark's judge takes it."""
    x = torch.as_tensor(X, device="cuda")
    yv = torch.as_tensor(y, device="cuda")
    h = torch.as_tensor(np.asarray(hyp, np.float64), device="cuda")
    u = x[-512:]
    ys, mu, sigma = ref_gp.standardized(yv)
    lb, ub = (ref_gp.to_standardized(b, mu, sigma)
              for b in ref_gp.hyp_bounds(x, yv))
    v = ref_gp.to_standardized(h, mu, sigma)
    _, g = ref.nll_grad(x, ys, v, u, ref.JITTER / sigma ** 2)
    pg = ref_gp.projected_gradient(v.cpu(), g.cpu() / x.shape[0], lb, ub)
    return ref.nll(x, yv, h, u), pg


def _err(rec):
    """The record's own error: its NLL's gap to the float64 oracle."""
    return rec["oracle_rel_diff"] * abs(rec["oracle_f64_nll"])


def test_nll_at_the_records_hyps_matches_the_oracle(data):
    rec, X, y = data
    gp = _model(X, y)
    got = gp.nll(np.asarray(rec["hyp"]))
    want = rec["oracle_f64_nll"]
    tol = 16 * EPS * _scale(gp, rec["hyp"], gp.train_in, gp.inducing) * abs(
        want)
    print(f"\nFITC NLL at the record's hyps {got!r}, oracle {want!r}: "
          f"{abs(got - want):.3e} apart, tolerance {tol:.3e}")
    assert abs(got - want) <= tol


def test_the_record_stopped_short_of_a_stationary_point(data):
    """From the record's hyperparameters train() capped at ten evaluations
    descend by more than MARGIN times the record's own error, and its
    projected gradient is a tenth of a row or more."""
    rec, X, y = data
    nll0, pg0 = _reference(X, y, rec["hyp"])
    gp = _model(X, y)
    gp._MAX_EVAL = 10
    gp.train(init_hyps=np.asarray(rec["hyp"]))
    nll10, _ = _reference(X, y, gp.get_hyp())
    print(f"\nat the record: NLL {nll0!r}, projected gradient {pg0:.4f} a "
          f"row; after {gp.last_opt_result.evals} evaluations from there "
          f"{nll10!r} ({nll0 - nll10:.1f} below; the record's error "
          f"{_err(rec):.3f})")
    assert pg0 >= 0.1
    assert nll10 < nll0 - MARGIN * _err(rec)


def test_train_goes_past_the_record(data):
    """train() from the library's start: within its budget it ends below
    the record's NLL by more than MARGIN record errors, nearer a
    stationary point than the record (half its projected gradient or
    less), and predicts the held-out rows better than the record (the
    constant predictor reads 0.88)."""
    rec, X, y = data
    gp = _model(X, y)
    own = gp.train()
    h = gp.get_hyp()
    nll, pg = _reference(X, y, h)
    _, pg_rec = _reference(X, y, rec["hyp"])
    Xs, ys = make_data(2000, 10, seed=7)
    mu = gp.batch_predict_y(Xs).cpu().numpy()
    rmse = float(np.sqrt(np.mean((mu - ys) ** 2)))
    print(f"\nFITC train(): NLL {nll!r} by the reference ({own!r} its "
          f"own) after "
          f"{gp.last_opt_result.evals} evaluations, projected gradient "
          f"{pg:.4f} (the record's {pg_rec:.4f}), RMSE {rmse:.5f}; record "
          f"{rec['final_nll']!r}, {rec['heldout_rmse']}; log sn "
          f"{float(h[-2]):.3f} (the record's {rec['hyp'][-2]:.3f})")
    assert gp.last_opt_result.evals <= gp._MAX_EVAL + 25
    assert nll < rec["final_nll"] - MARGIN * _err(rec)
    assert pg <= 0.5 * pg_rec
    assert rmse < rec["heldout_rmse"]
