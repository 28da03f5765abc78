"""The variance's test-input gradient (models/exact.predict_s2_with_grad)
on the CPU in float64.

The port computes it in gp_tpu's hoisted form: one solve K^-1 k* outside
autograd, then the vjp of the K(X*, X) build at cotangent -2 K^-1 k*.
The tests hold it against central finite differences of predict_s2 and
against autograd through the solve (the direct form, kept below as a
reference), for each solver and for SE-ARD, Matern-5/2 and RQ; and they count
its solves: one solver call, and no solve in the autograd graph that it
differentiates under the predict.backward span.

Tolerances and why:
- finite differences at 1e-6 of the largest entry: a central difference at h = 1e-5 errs
  by ~h^2 |s2'''| (~1e-10) and by ~eps |s2| / h (~1e-11);
- autograd through the solve at 1e-10 of the largest entry: the same quantity, the two
  forms apart only by rounding (K^-T b against K^-1 b for the QR solvers).
"""

import numpy as np
import pytest
import torch

from gp_tpu_torch.models import exact as te
from gp_tpu_torch.models.base import hyp_sn2
from gp_tpu_torch.ops import kernels as tk
from gp_tpu_torch.ops.solvers import get_solver
from gp_tpu_torch.utils import profiling
from gp_tpu_torch.utils.profiling import span

N, D, T = 96, 4, 7
SOLVERS = ["chol", "qr", "qr_pivot"]
FORMS = ["se_ard", "matern52", "rq"]


def _problem(form, solver, scale=1.0):
    """(kernel, hyp, x, f, xs, solver) at N rows, the noise sn = 0.1; f
    factors scale * K."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(-1.5, 1.5, (N, D)))
    xs = torch.tensor(rng.uniform(-1.5, 1.5, (T, D)))
    kernel, solver = tk.get_kernel(form), get_solver(solver)
    chyp = [0.3, -0.2, 0.1, 0.4, 0.2] + ([0.5] if form == "rq" else [])
    hyp = torch.tensor(chyp + [np.log(0.1), 0.05], dtype=torch.float64)
    K = tk.get_k_noise(kernel)(hyp[:len(chyp)], hyp_sn2(hyp), x, N)
    return kernel, hyp, x, solver.factor(scale * K), xs, solver


def _through_the_solve(kernel, hyp, x, f, xs, solver):
    """(s2, ds2/dx*) by autograd of s2.sum() through the solve, whose
    backward solves the system again; the clamp straight through."""
    chyp = hyp[:kernel.num_hyp(x.shape[1])]
    xs = xs.detach().requires_grad_(True)
    with torch.enable_grad():
        kt = kernel.k(chyp, xs, x)
        with span("predict.solve"):
            kks = solver.solve(f, kt.T)
        quad = torch.sum(kt * kks.T, dim=1)
        sf2 = kernel.diag_k(chyp, xs)
        raw = sf2 - quad + hyp_sn2(hyp)
        clamped = torch.clamp(sf2 - quad, min=0.0) + hyp_sn2(hyp)
        s2 = raw + (clamped - raw).detach()
        with span("predict.backward"):
            g, = torch.autograd.grad(s2.sum(), xs)
    return s2.detach(), g


def _unclamped_s2(kernel, hyp, x, f, xs, solver):
    chyp = hyp[:kernel.num_hyp(x.shape[1])]
    kt = kernel.k(chyp, xs, x)
    return (kernel.diag_k(chyp, xs) - torch.sum(kt * solver.solve(f, kt.T).T,
                                                dim=1) + hyp_sn2(hyp))


def _central_differences(fn, xs, h=1e-5):
    """(T, D) of d fn(xs)[i] / d xs[i, j]: row i of fn depends on xs[i]
    alone, so one pair of calls per column gives every row's partial."""
    cols = []
    for j in range(xs.shape[1]):
        e = torch.zeros_like(xs)
        e[:, j] = h
        cols.append((fn(xs + e) - fn(xs - e)) / (2.0 * h))
    return torch.stack(cols, dim=1)


def _rel(a, b):
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def _graph(outputs):
    """The names of the autograd nodes reachable from outputs."""
    seen, todo = set(), [o.grad_fn for o in outputs if o.grad_fn is not None]
    while todo:
        node = todo.pop()
        if node is not None and node not in seen:
            seen.add(node)
            todo.extend(nxt for nxt, _ in node.next_functions)
    return sorted(type(n).__name__ for n in seen)


def _count_solves(fn, problem, monkeypatch):
    """One fn call on problem under the tracer: (the spans open at each
    solver.solve call, and for each torch.autograd.grad call the spans
    open at it and the nodes of the graph it differentiates)."""
    kernel, hyp, x, f, xs, solver = problem
    solves, grads, grad = [], [], torch.autograd.grad

    def open_spans():
        return [t.spans[i][0] for i in t._open]

    def solve(f, b):
        solves.append(open_spans())
        return solver.solve(f, b)

    def autograd_grad(outputs, *args, **kwargs):
        outs = [outputs] if torch.is_tensor(outputs) else list(outputs)
        grads.append((open_spans(), _graph(outs)))
        return grad(outputs, *args, **kwargs)

    monkeypatch.setattr(torch.autograd, "grad", autograd_grad)
    with profiling.tracing() as t:
        fn(kernel, hyp, x, f, xs, solver._replace(solve=solve))
    return solves, grads


def _solves_in(graph):
    return [n for n in graph
            if any(w in n.lower() for w in ("solve", "cholesky"))]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("solver", SOLVERS)
def test_gradient_matches_finite_differences_and_the_solve_autograd(
        solver, form):
    kernel, hyp, x, f, xs, spec = p = _problem(form, solver)
    s2, g = te.predict_s2_with_grad(*p)
    s2_ref, g_ref = _through_the_solve(*p)
    fd = _central_differences(
        lambda z: te.predict_s2(kernel, hyp, x, f, z, spec), xs)
    assert torch.all(s2 > hyp_sn2(hyp))          # no clamp engaged
    assert _rel(s2, s2_ref) <= 1e-12
    assert _rel(g, g_ref) <= 1e-10
    assert _rel(g, fd) <= 1e-6
    assert torch.max(torch.abs(fd)) > 1e-2       # a gradient to compare
    assert not s2.requires_grad and not g.requires_grad


def test_clamp_is_straight_through_where_it_engages():
    """The factor of K / 2 doubles k*^T K^-1 k*, so that inside the data
    sf2 - quad < 0 (the training rows here): the value is clamped to sn2,
    the gradient is the unclamped expression's (GP.cpp:294).  Two
    candidates outside the data keep a positive variance."""
    kernel, hyp, x, f, _, spec = _problem("se_ard", "chol", scale=0.5)
    xs = torch.cat([x[:3], torch.tensor([[1.8] * D, [2.0, 1.8, 2.2, 1.9]],
                                        dtype=torch.float64)])
    p = (kernel, hyp, x, f, xs, spec)
    s2, g = te.predict_s2_with_grad(*p)
    raw = _unclamped_s2(*p)
    engaged = raw < hyp_sn2(hyp)
    assert engaged[:3].all() and not engaged[3:].any()
    assert torch.equal(s2[:3], hyp_sn2(hyp).expand(3))
    _, g_ref = _through_the_solve(*p)
    assert _rel(g, g_ref) <= 1e-10
    fd = _central_differences(lambda z: _unclamped_s2(kernel, hyp, x, f, z,
                                                      spec), xs)
    assert _rel(g, fd) <= 1e-6
    assert torch.max(torch.abs(g[:3])) > 1e-2    # not the clamp's zero


@pytest.mark.parametrize("solver", SOLVERS)
def test_one_solve_and_none_under_the_backward(solver, monkeypatch):
    solves, grads = _count_solves(te.predict_s2_with_grad,
                                  _problem("se_ard", solver), monkeypatch)
    assert solves == [["predict.solve"]]
    (spans, graph), = grads
    assert spans == ["predict.backward"]
    assert "_CovKBackward" in graph and not _solves_in(graph)


def test_the_solve_count_sees_a_solve_inside_autograd(monkeypatch):
    """The instrument of the test above: autograd through the solve makes
    one solver call, and its backward differentiates the solve again."""
    solves, grads = _count_solves(_through_the_solve,
                                  _problem("se_ard", "chol"), monkeypatch)
    assert solves == [["predict.solve"]]
    (spans, graph), = grads
    assert spans == ["predict.backward"]
    assert _solves_in(graph) == ["CholeskySolveBackward0"]
