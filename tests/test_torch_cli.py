"""gp_tpu_torch's CLI (`python -m gp_tpu_torch gp|fitc|vfe`) on the CPU, on
text files the test writes from a seeded RNG, N <= 60.

`gp`: pred and the printed NLL against gp_tpu's cli.main on the same files
at rtol 1e-6.  The data (d = 2, a smooth function) has a well-determined
optimum, where both fits converge to it inside their budgets: where the
likelihood is flat, rounding decides where each fit stops (ROADMAP §3,
"Recorded, not to repair"; at N = 50 from make_data's d = 8 the two stop
2e-5 apart in f, at 157 and 160 evaluations).  `fitc` and `vfe`: against
the port's own model fitted in the process as the CLI fits it, with the
test_obj table checked (this keeps the JAX compiles of the file to
gp_tpu's one exact fit).
"""

import re

import numpy as np
import pytest

from gp_tpu import cli as jcli
from gp_tpu_torch import FITC, VFE, cli
from gp_tpu_torch.utils.io import read_matrix, write_matrix

N_TRAIN, N_TEST, M = 60, 15, 12


@pytest.fixture()
def files(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    X = rng.uniform(-3, 3, (N_TRAIN + N_TEST, 2))
    y = np.sin(X[:, 0]) + 0.5 * np.cos(X[:, 1]) \
        + 0.05 * rng.standard_normal(N_TRAIN + N_TEST)
    write_matrix(str(tmp_path / "train_x"), X[:N_TRAIN])
    write_matrix(str(tmp_path / "train_y"), y[:N_TRAIN])
    write_matrix(str(tmp_path / "test_x"), X[N_TRAIN:])
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _nll(text):
    return float(re.search(r"Negative log likelihood: (\S+)", text).group(1))


def test_gp_matches_gp_tpu_cli(files, capsys):
    assert jcli.main(["gp", "50", "--cpu"]) == 0
    out_j = capsys.readouterr().out
    pred_j = read_matrix("pred")
    assert cli.main(["gp", "50", "--cpu"]) == 0
    out_t = capsys.readouterr().out
    pred_t = read_matrix("pred")
    np.testing.assert_allclose(_nll(out_t), _nll(out_j), rtol=1e-6)
    assert pred_t.shape == (N_TEST, 2)
    np.testing.assert_allclose(pred_t, pred_j, rtol=1e-6, atol=1e-6)
    assert "Prediction time:" in out_t and "Optimized hyperparameters:" \
        in out_t


@pytest.mark.parametrize("model", ["fitc", "vfe"])
def test_sparse_matches_in_process_model(files, capsys, model):
    assert cli.main([model, str(N_TRAIN), str(M), "--cpu"]) == 0
    out = capsys.readouterr().out
    pred = read_matrix("pred")
    X, y, Xs = (read_matrix(f) for f in ("train_x", "train_y", "test_x"))
    m = (FITC if model == "fitc" else VFE)(X, y.ravel(), device="cpu")
    m.set_inducing(X[-M:])              # the last M rows, as the reference
    init = m.get_default_hyps()
    if model == "vfe":
        init[-2] = np.log(np.std(y, ddof=1))
    nll = m.train(init)
    np.testing.assert_allclose(_nll(out), nll, rtol=1e-8)
    mu = m.batch_predict_y(Xs).numpy()
    sd = np.sqrt(m.batch_predict_s2(Xs).numpy())
    np.testing.assert_allclose(pred, np.stack([mu, sd], 1), rtol=1e-12,
                               atol=1e-12)
    # the test_obj table: one row a hyperparameter (hyp, analytic and
    # numeric gradient), as the model's test_obj gives them, to the
    # printed digits (9 for the NLL, 6 in the table)
    head = out.index("test_obj nll:")
    nll_chk, g, fd = m.test_obj(m.get_hyp())
    np.testing.assert_allclose(float(out[head:].split()[2]), nll_chk,
                               rtol=1e-8)
    rows = out[head:].splitlines()[2:2 + m.num_hyp]
    table = np.array([[float(v) for v in r.split()] for r in rows])
    for col, want in enumerate((m.get_hyp(), g, fd)):
        np.testing.assert_allclose(table[:, col], want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_cli_rejects_what_the_reference_rejects(files, capsys):
    assert cli.main(["gp", str(N_TRAIN + 1), "--cpu"]) == 1
    assert cli.main(["fitc", "10", str(N_TRAIN + 1), "--cpu"]) == 1
    assert "Num" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["gp", "--kernel", "no_such_kernel", "--cpu"])
