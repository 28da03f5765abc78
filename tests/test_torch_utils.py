"""gp_tpu_torch's utilities against gp_tpu's, on the CPU in float64:
utils/stats.py (every function, logphi in its three branches with its
gradient, at rtol 1e-12), utils/io.py through the native reader and writer
(native/fastio.py) and through the NumPy fallback, and utils/profiling.py.

rand_matrix is held to gp_tpu's on replayed draws: gp_tpu's
jax.random.uniform over [-1, 1) is 2 u - 1 of the same key's uniform u
over [0, 1), which a draw source hands the port's rand_matrix.
"""

import jax
import numpy as np
import pytest
import torch

from gp_tpu.native import fastio as jfastio
from gp_tpu.utils import io as jio
from gp_tpu.utils import stats as js
from gp_tpu_torch.native import fastio
from gp_tpu_torch.utils import io, profiling
from gp_tpu_torch.utils import stats as ts

RECS = np.array([[5.0, -1.0, 0.0],    # feasible, obj 5
                 [1.0, 2.0, 0.0],     # infeasible, violation 2
                 [3.0, -2.0, -1.0],   # feasible, obj 3: the best
                 [0.0, 0.5, 0.5]])    # infeasible, violation 1


def _n(t):
    return t.detach().cpu().numpy()


def _same(t, j, rtol=1e-12):
    np.testing.assert_allclose(_n(t), np.asarray(j), rtol=rtol, atol=0)


def test_moments_and_normal():
    rng = np.random.default_rng(1)
    v = rng.standard_normal(97)
    _same(ts.stdvar(v), js.stdvar(v))
    _same(ts.stddev(v), js.stddev(v))
    x = np.linspace(-6, 6, 41)
    _same(ts.normpdf(x), js.normpdf(x))
    _same(ts.normcdf(x), js.normcdf(x))


def test_logphi_three_branches_match():
    # |x| small (x^2 < 0.0492), very negative (x < -11.3137), erfc between
    x = np.array([-40.0, -15.0, -11.4, -11.2, -5.0, -0.22, -0.2, -0.1, 0.0,
                  0.1, 0.2, 0.23, 1.0, 5.0, 9.0])
    (lp_t, dlp_t), (lp_j, dlp_j) = ts.logphi(x), js.logphi(x)
    _same(lp_t, lp_j)
    _same(dlp_t, dlp_j)


def test_feasibility_rule_matches():
    for a in RECS:
        assert bool(ts.is_feas(a)) == bool(js.is_feas(a))
        _same(ts.violation(a), js.violation(a))
        for b in RECS:
            assert bool(ts.better(a, b)) == bool(js.better(a, b))
    _same(ts.violation(RECS), js.violation(RECS))
    _same(ts.better(RECS, RECS[::-1]), js.better(RECS, RECS[::-1]))
    for recs in (RECS, RECS[[1, 3]], RECS[:, :1]):
        (i_t, row_t), (i_j, row_j) = ts.find_best(recs), js.find_best(recs)
        assert int(i_t) == int(i_j)
        _same(row_t, row_j)
    xs = np.arange(12.0).reshape(3, 4)
    (x_t, y_t), (x_j, y_j) = ts.find_best_xy(xs, RECS), \
        js.find_best_xy(xs, RECS)
    _same(x_t, x_j)
    _same(y_t, y_j)


class Replay:
    """A draw source that hands out gp_tpu's uniform draws of `key`."""

    def __init__(self, key):
        self.key = key

    def uniform(self, shape, dtype, device):
        u = jax.random.uniform(self.key, shape, jax.numpy.float64)
        return torch.tensor(np.asarray(u), dtype=dtype, device=device)


def test_rand_matrix_replays_gp_tpu():
    key = jax.random.PRNGKey(7)
    lb, ub = np.array([-1.0, 0.0, 2.0]), np.array([1.0, 5.0, 2.5])
    _same(ts.rand_matrix(Replay(key), 9, lb, ub),
          js.rand_matrix(key, 9, lb, ub), rtol=0)
    # the contract with a torch.Generator: the shape and the box
    m = ts.rand_matrix(torch.Generator().manual_seed(0), 500, lb, ub)
    assert m.shape == (3, 500) and m.dtype == torch.float64
    assert bool((m >= torch.tensor(lb)[:, None]).all()
                and (m <= torch.tensor(ub)[:, None]).all())


def test_option_helpers():
    v = np.array([3.0, 9.0, 1.0, 7.0])
    np.testing.assert_array_equal(ts.top_largest(torch.tensor(v), 2),
                                  js.top_largest(v, 2))
    np.testing.assert_array_equal(ts.top_largest(v, 9), js.top_largest(v, 9))
    assert ts.with_default({"a": 1}, "b", 2) == 2
    assert ts.get_required({"a": 1}, "a") == 1
    with pytest.raises(KeyError, match="required option 'b'"):
        ts.get_required({"a": 1}, "b")


@pytest.mark.parametrize("native", [True, False])
def test_io_round_trip(tmp_path, monkeypatch, native):
    """Native (g++-built) and NumPy paths: 17 digits round-trip float64
    exactly, and read gp_tpu's files as gp_tpu reads them."""
    if native:
        assert fastio._load() is not None, "g++ could not build fastio.cpp"
    else:
        monkeypatch.setattr(fastio, "_load", lambda: None)
    m = np.random.default_rng(2).standard_normal((7, 3)) * 1e3
    io.write_matrix(tmp_path / "m", m)
    np.testing.assert_array_equal(io.read_matrix(str(tmp_path / "m")), m)
    jio.write_matrix(str(tmp_path / "j"), m)
    np.testing.assert_array_equal(io.read_matrix(str(tmp_path / "j")),
                                  jio.read_matrix(str(tmp_path / "j")))
    io.write_pred(str(tmp_path / "pred"), m[:, 0], np.abs(m[:, 1]))
    p = io.read_matrix(str(tmp_path / "pred"))
    np.testing.assert_array_equal(p, np.stack([m[:, 0], np.abs(m[:, 1])], 1))
    (tmp_path / "ragged").write_text("1 2\n3\n")
    (tmp_path / "empty").write_text("")
    for bad, err in (("ragged", ValueError), ("empty", ValueError),
                     ("missing", FileNotFoundError)):
        with pytest.raises(err):
            io.read_matrix(str(tmp_path / bad))


def test_native_writer_matches_gp_tpus_bytes(tmp_path):
    if jfastio._load() is None:
        pytest.skip("gp_tpu's native writer is unavailable")
    m = np.random.default_rng(3).standard_normal((5, 4))
    io.write_matrix(str(tmp_path / "t"), m)
    jio.write_matrix(str(tmp_path / "j"), m)
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


def test_profiling_helpers(tmp_path, capsys):
    out = []
    with profiling.phase("demo", sink=lambda n, dt: out.append((n, dt))):
        torch.ones(10, 10) @ torch.ones(10, 10)
    assert out and out[0][0] == "demo" and out[0][1] >= 0
    with profiling.phase("printed"):
        pass
    assert "[gp_tpu_torch] printed:" in capsys.readouterr().out
    t = profiling.Timer()
    for _ in range(3):
        with t("step"):
            torch.ones(4) + 1
    assert t.count["step"] == 3 and "step: " in str(t)
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
