"""A run with the timed path broken underneath comes out not correct: each
fault that a cell can have, planted in the program, in a shrunk cell on
the CPU (the harness's look for a chip skipped).  The stream cell has no
state that a step moves, so it has no unchanged-state fault."""

import pytest

from gpbench import harness
from gpbench.control import Capped, Frozen

from .shared import ROOT, STREAM_MIN_N, small


def _alter(mu):
    mu = mu.clone()
    mu[0] += 0.05 * mu.abs().max()
    return mu


def _half(out, m):
    """The first half of a batch's answers, the rest set to their mean."""
    out = out.clone()
    out[m // 2:] = out[:m // 2].mean(0)
    return out


def fit_state_unchanged(mp, ex):
    from gp_tpu_torch.optim import lbfgsb
    mp.setattr(lbfgsb, "_lbfgsb_run", lambda fun, st, *a, **k: st)


def fit_capped(mp, ex):
    """Every fit stopped at a quarter of the library's budget: the
    control's Capped, as the limits' readings plant it."""
    return Capped


def fit_steepest(mp, ex):
    """The optimizer's L-BFGS direction replaced by -g (control's
    steepest_descent)."""
    from gp_tpu_torch.optim import lbfgsb
    mp.setattr(lbfgsb, "_two_loop", lambda st: -st.g)


def fit_half_batch(mp, ex):
    orig = ex.nll_vg_raw

    def half(kernel, hyp, x, y, *a, **k):
        h = x.shape[0] // 2
        v, g = orig(kernel, hyp, x[:h], y[:h], *a, **k)
        return 2.0 * v, 2.0 * g
    mp.setattr(ex, "nll_vg_raw", half)


def fit_answer_altered(mp, ex):
    orig = ex.predict
    mp.setattr(ex, "predict", lambda *a, **k: (
        lambda mu, s2: (_alter(mu), s2))(*orig(*a, **k)))


def predict_half_batch(mp, ex):
    orig = ex.predict_streamed

    def half(kernel, hyp, x, invKys, xs):
        mu, s2 = orig(kernel, hyp, x, invKys, xs)
        return _half(mu, xs.shape[0]), _half(s2, xs.shape[0])
    mp.setattr(ex, "predict_streamed", half)


def predict_answer_altered(mp, ex):
    orig = ex.predict_streamed
    mp.setattr(ex, "predict_streamed", lambda *a: (
        lambda mu, s2: (_alter(mu), s2))(*orig(*a)))


def bo_state_unchanged(mp, ex):
    """Every absorb left out: the control's Frozen."""
    return Frozen


def bo_half_batch(mp, ex):
    orig = ex.predict_y_with_grad

    def half(kernel, hyp, x, invKys, xs):
        mu, g = orig(kernel, hyp, x, invKys, xs)
        return _half(mu, xs.shape[0]), _half(g, xs.shape[0])
    mp.setattr(ex, "predict_y_with_grad", half)


def bo_answer_altered(mp, ex):
    orig = ex.predict_y_with_grad
    mp.setattr(ex, "predict_y_with_grad", lambda *a: (
        lambda mu, g: (_alter(mu), g))(*orig(*a)))


FAULTS = {"bundled8k_fit": [None, fit_state_unchanged, fit_capped,
                            fit_steepest, fit_half_batch,
                            fit_answer_altered],
          "stream51k_predict": [None, predict_half_batch,
                                predict_answer_altered],
          "bundled8k_bo": [None, bo_state_unchanged, bo_half_batch,
                           bo_answer_altered]}
CASES = [(w, f) for w, fs in FAULTS.items() for f in fs]


@pytest.mark.parametrize("workload, fault", CASES, ids=[
    f"{w}-{f.__name__ if f else 'sound'}" for w, f in CASES])
def test_a_planted_fault_is_not_correct(monkeypatch, workload, fault):
    from gp_tpu_torch.models import exact
    if workload.startswith("stream"):
        monkeypatch.setattr(exact, "_STREAM_MIN_N", STREAM_MIN_N)
    program = fault(monkeypatch, exact) if fault is not None else None
    # a window long enough that a BO run judges steps after absorbs on a
    # busy CPU (a fit window is one pass of the pool, however short)
    line = harness.run(ROOT, workload, 21, 1.5, False, "cpu",
                       program=program, overrides=small(workload))
    assert line["correct"] is (fault is None), line["checks"]
