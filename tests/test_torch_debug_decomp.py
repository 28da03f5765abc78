"""gp_tpu_torch's per-evaluation NLL breakdown against gp_tpu's (MYDEBUG
parity: GP.cpp:144-146, VFE.cpp:242-245), on the CPU in float64.

Under GP_TPU_DEBUG=1 and GP_TPU_VERBOSE_OPT=1 both packages print one
"[GP_TPU_DEBUG] <tag>: key=value ..." line per evaluation, with the same
keys in the same order: the terms rebuild the returned NLL at rtol 1e-12
and equal gp_tpu's printed terms at rtol 1e-10.  Nothing is printed
without the switches, nor by BucketedGP's objective (gp_tpu's masked
family prints nothing).  gp_tpu reads its switch at trace time, so its
jitted calls here use shapes (n = 29, 31) that no other test traces.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gp_tpu import SE_ARD
from gp_tpu.models import exact as je
from gp_tpu.models import fitc as jf
from gp_tpu.models import vfe as jv
from gp_tpu.models.base import default_hyps
from gp_tpu_torch import BucketedGP
from gp_tpu_torch.models import exact as te
from gp_tpu_torch.models import fitc as tf
from gp_tpu_torch.models import vfe as tv
from gp_tpu_torch.ops.kernels import get_kernel

KEYS = {"nll": ("nlz", "data_fit", "half_logdet", "norm_const"),
        "nll_vg": ("nlz", "data_fit", "half_logdet", "norm_const"),
        "fitc_nll": ("nlz", "data_fit", "complexity", "norm_const"),
        "vfe_nll": ("nlz", "data_fit", "complexity", "trace_term",
                    "norm_const")}
K = get_kernel("se_ard")


@pytest.fixture()
def debug_env(monkeypatch):
    monkeypatch.setenv("GP_TPU_DEBUG", "1")
    monkeypatch.setenv("GP_TPU_VERBOSE_OPT", "1")


def _problem(n, seed):
    """Data and gp_tpu's default hyps with the noise raised to 0.1: at the
    default's noise floor (sigma_n = 1e-3) FITC's data-fit term amplifies
    the builds' last-bit rounding: the two packages' NLLs part by 2e-10
    there at n = 31."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 2))
    y = np.sin(X[:, 0]) + 0.1 * rng.standard_normal(n)
    hyp = default_hyps(SE_ARD, X, y, 1e-3, False)
    hyp[-2] = np.log(0.1)
    return X, y, hyp


def _terms(text, tag):
    """{key: value} of the one line with `tag`, keys in printed order."""
    lines = [ln for ln in text.splitlines()
             if ln.startswith(f"[GP_TPU_DEBUG] {tag}: ")]
    assert len(lines) == 1, text
    pairs = re.findall(r"(\w+)=(\S+)", lines[0].split(": ", 1)[1])
    assert tuple(k for k, _ in pairs) == KEYS[tag]
    return {k: float(v) for k, v in pairs}


def _check(text_t, text_j, tag, value, rebuild):
    t, j = _terms(text_t, tag), _terms(text_j, tag)
    np.testing.assert_allclose(sum(t[k] for k in rebuild), t["nlz"],
                               rtol=1e-12)
    np.testing.assert_allclose(t["nlz"], value, rtol=1e-12)
    for k in KEYS[tag]:
        np.testing.assert_allclose(t[k], j[k], rtol=1e-10, atol=1e-12)


def test_exact_breakdown_matches_gp_tpu(debug_env, capfd):
    X, y, hyp = _problem(29, 0)
    float(je.nll(SE_ARD, hyp, X, y))
    je.nll_vg_raw(SE_ARD, jnp.asarray(hyp), jnp.asarray(X),
                  jnp.asarray(y))[0].block_until_ready()
    text_j = capfd.readouterr().out
    th, tx, ty = (torch.tensor(a) for a in (hyp, X, y))
    v = float(te.nll_raw(K, th, tx, ty))
    text_t = capfd.readouterr().out
    _check(text_t, text_j, "nll", v, KEYS["nll"][1:])
    f, _ = te.nll_vg_raw(K, th, tx, ty)
    text_t = capfd.readouterr().out
    _check(text_t, text_j, "nll_vg", float(f), KEYS["nll"][1:])


def test_sparse_breakdown_matches_gp_tpu(debug_env, capfd):
    X, y, hyp = _problem(31, 1)
    args_j = (jnp.asarray(hyp), jnp.asarray(X), jnp.asarray(y),
              jnp.asarray(X[-7:]), 1e-8)
    args_t = (torch.tensor(hyp), torch.tensor(X), torch.tensor(y),
              torch.tensor(X[-7:]), torch.tensor(1e-8, dtype=torch.float64))
    for tag, jm, tm in (("fitc_nll", jf, tf), ("vfe_nll", jv, tv)):
        jm.nll_raw(SE_ARD, *args_j).block_until_ready()
        text_j = capfd.readouterr().out
        v = float(tm.nll_raw(K, *args_t))
        text_t = capfd.readouterr().out
        rebuild = ("data_fit", "complexity", "norm_const") + (
            ("trace_term",) if tag == "vfe_nll" else ())
        _check(text_t, text_j, tag, v, rebuild)


def test_breakdown_silent_by_default(capfd, monkeypatch):
    monkeypatch.setenv("GP_TPU_VERBOSE_OPT", "1")    # debug mode still off
    monkeypatch.delenv("GP_TPU_DEBUG", raising=False)
    X, y, hyp = _problem(29, 2)
    th, tx, ty = (torch.tensor(a) for a in (hyp, X, y))
    te.nll_raw(K, th, tx, ty)
    te.nll_vg_raw(K, th, tx, ty)
    tf.nll_raw(K, th, tx, ty, tx[-7:], torch.tensor(1e-8, dtype=tx.dtype))
    assert "[GP_TPU_DEBUG]" not in "".join(capfd.readouterr())


def test_bucketed_objective_prints_nothing(debug_env, capfd):
    X, y, hyp = _problem(29, 3)
    m = BucketedGP(X, y, bucket=16, device="cpu")
    v = m._tensor(m._hyp_to_std(hyp))
    m._objective_closure()(v)
    m._multistart_objective()(v[None])
    m.nll(hyp)
    assert "[GP_TPU_DEBUG]" not in "".join(capfd.readouterr())
