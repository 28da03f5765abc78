"""gp_tpu_torch's Matern and RQ covariances against gp_tpu's, on the CPU in
float64.

The same seeded numpy inputs go through the JAX function and its port.
Tolerances and why:
- plain K1/K2 of each form against gp_tpu's Pallas kernels in interpret
  mode: those round the cross term to float32 even for float64 inputs
  (pallas_kernels.py:76-81, ROADMAP Faults), so each entry may move by
  max |dk/dsq| times the float32 error of sq;
- `k`, `k_noise` and `diag_k` of the six specs: rtol 1e-12 (the same
  float64 formula in the same order);
- the closed-form backwards against jax.vjp of gp_tpu's custom_vjp
  functions with the same cotangent: rtol 1e-10 (GEMM reduction order);
- the closed-form backwards against autograd of the plain formulas:
  rtol 1e-8, as gp_tpu's own test_kernels_extra holds its VJPs.
The CUDA kernel is held against its plain version in
tests/test_torch_cuda.py (marker `cuda`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_tpu.ops.pallas_kernels as pk
from gp_tpu.ops import kernels as jk
from gp_tpu.ops import kernels_extra as jkx  # noqa: F401  (registers)
from gp_tpu_torch.ops import kernels as tk
from gp_tpu_torch.ops import kernels_extra as tkx
from gp_tpu_torch.ops import se_tile

NAMES = ["matern52", "matern52_iso", "matern32", "matern32_iso", "rq",
         "rq_iso"]
# (form, p1): RQ at a small and a large alpha
FORMS = [("m52", 1.0), ("m32", 1.0), ("rq", 0.7), ("rq", 50.0)]
# max |dk/dsq| / sf2 of each form, at sq = 0
MAX_SLOPE = {"m52": 5.0 / 6.0, "m32": 1.5, "rq": 0.5}


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a, np.float64),
                        requires_grad=requires_grad)


def _n(t):
    return t.detach().cpu().numpy()


def _f32_sq_error(a, b):
    """max |d sq| when the cross term a.b is rounded to float32: 2 d eps32
    (|a|^2 + |b|^2) over d terms."""
    d = a.shape[1]
    eps = float(np.finfo(np.float32).eps)
    return 2 * d * eps * ((a * a).sum(1).max() + (b * b).sum(1).max())


def _chyp(rng, name, d):
    nc = tk.get_kernel(name).num_hyp(d)
    c = rng.uniform(-0.6, 0.6, nc)
    if name.startswith("rq"):
        c[-1] = np.log(0.7)            # off-default alpha
    return c


@pytest.mark.parametrize("form,p1", FORMS)
@pytest.mark.parametrize("m,n,d", [(70, 130, 5), (33, 33, 1)])
def test_plain_k2_form_matches_pallas_interpret(form, p1, m, n, d):
    rng = np.random.default_rng(5)
    x1, x2 = rng.standard_normal((m, d)), rng.standard_normal((n, d))
    inv_l = np.exp(rng.uniform(-1, 1, d))
    K = pk.se_matrix(jnp.asarray(inv_l), 2.5, jnp.asarray(x1),
                     jnp.asarray(x2), interpret=True, form=form, p1=p1)
    Kt = se_tile.se_matrix_plain(_t(inv_l), 2.5, _t(x1), _t(x2), form, p1)
    err = np.max(np.abs(_n(Kt) - np.asarray(K))) / 2.5
    assert err <= MAX_SLOPE[form] * _f32_sq_error(x1 * inv_l, x2 * inv_l)


@pytest.mark.parametrize("form,p1", FORMS)
def test_plain_k1_form_matches_pallas_interpret(form, p1):
    rng = np.random.default_rng(6)
    n, d = 140, 3
    x = rng.standard_normal((n, d))
    inv_l = np.exp(rng.uniform(-0.3, 0.3, d))
    sf2 = 1.7
    dvals = np.where(np.arange(n) < n - 9, sf2 + 0.09, sf2)
    K = pk.se_matrix_diag(jnp.asarray(inv_l), sf2, jnp.asarray(x),
                          jnp.asarray(dvals), tile=128, interpret=True,
                          form=form, p1=p1)
    Kt = se_tile.se_matrix_diag_plain(_t(inv_l), sf2, _t(x), _t(dvals),
                                      form, p1)
    err = np.max(np.abs(_n(Kt) - np.asarray(K))) / sf2
    assert err <= MAX_SLOPE[form] * _f32_sq_error(x * inv_l, x * inv_l)
    # the diagonal is written, not computed: exact
    np.testing.assert_array_equal(np.diag(_n(Kt)), np.diag(np.asarray(K)))


@pytest.mark.parametrize("name", NAMES)
def test_k_k_noise_and_diag_k_match(name):
    js, ts = jk.get_kernel(name), tk.get_kernel(name)
    rng = np.random.default_rng(1)
    m, n, d = 57, 40, 4
    x1, x2 = rng.standard_normal((m, d)), rng.standard_normal((n, d))
    chyp = _chyp(rng, name, d)
    np.testing.assert_allclose(_n(ts.k(_t(chyp), _t(x1), _t(x2))),
                               np.asarray(js.k(chyp, x1, x2)),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(_n(ts.diag_k(_t(chyp), _t(x1))),
                               np.asarray(js.diag_k(chyp, x1)), rtol=1e-14)
    for n_real in (m, m - 7):
        np.testing.assert_allclose(
            _n(ts.k_noise(_t(chyp), 0.09, _t(x1), n_real)),
            np.asarray(js.k_noise(chyp, 0.09, x1, n_real)), rtol=1e-12,
            atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_k_backward_matches_jax_vjp(name):
    js, ts = jk.get_kernel(name), tk.get_kernel(name)
    rng = np.random.default_rng(7)
    m, n, d = 37, 29, 4
    x1, x2 = rng.standard_normal((m, d)), rng.standard_normal((n, d))
    x2[:5] = x1[:5]                    # coincident pairs: r = 0
    chyp = _chyp(rng, name, d)
    G = rng.standard_normal((m, n))
    Kj, vjp = jax.vjp(js.k, jnp.asarray(chyp), jnp.asarray(x1),
                      jnp.asarray(x2))
    gj = vjp(jnp.asarray(G))
    args = (_t(chyp, True), _t(x1, True), _t(x2, True))
    Kt = ts.k(*args)
    gt = torch.autograd.grad(Kt, args, _t(G))
    np.testing.assert_allclose(_n(Kt), np.asarray(Kj), rtol=1e-12)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-13)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n_real", [64, 50])
def test_k_noise_backward_matches_jax_vjp(name, n_real):
    js, ts = jk.get_kernel(name), tk.get_kernel(name)
    rng = np.random.default_rng(8)
    n, d = 64, 3
    x = rng.standard_normal((n, d))
    chyp = _chyp(rng, name, d)
    sn2 = 0.07
    G = rng.standard_normal((n, n))
    G = G + G.T
    # cotangent contract: zero on the diagonal rows >= n_real
    G[np.arange(n_real, n), np.arange(n_real, n)] = 0.0
    Kj, vjp = jax.vjp(lambda c, s, xx: js.k_noise(c, s, xx, n_real),
                      jnp.asarray(chyp), jnp.asarray(sn2), jnp.asarray(x))
    gj = vjp(jnp.asarray(G))
    args = (_t(chyp, True), _t(sn2, True), _t(x, True))
    Kt = ts.k_noise(*args, n_real)
    gt = torch.autograd.grad(Kt, args, _t(G))
    np.testing.assert_allclose(_n(Kt), np.asarray(Kj), rtol=1e-12)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-13)


def _plain_formula(name):
    ard = not name.endswith("_iso")
    if name.startswith("rq"):
        return tkx._rq_k_ard if ard else tkx._rq_k_iso
    nu = np.sqrt(5.0) if "52" in name else np.sqrt(3.0)
    return (tkx._ard if ard else tkx._iso)(tkx._matern_k(nu))


@pytest.mark.parametrize("name", NAMES)
def test_closed_form_backward_matches_autograd_of_plain_formula(name):
    ts = tk.get_kernel(name)
    rng = np.random.default_rng(3)
    m, n, d = 40, 15, 3
    x1, x2 = rng.uniform(-2, 2, (m, d)), rng.uniform(-2, 2, (n, d))
    chyp = _chyp(rng, name, d)
    G = _t(rng.standard_normal((m, n)))
    outs = []
    for f in (ts.k, _plain_formula(name)):
        args = (_t(chyp, True), _t(x1, True), _t(x2, True))
        K = f(*args)
        outs.append((K, torch.autograd.grad(K, args, G)))
    (K1, g1), (K0, g0) = outs
    np.testing.assert_allclose(_n(K1), _n(K0), rtol=1e-12)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(_n(a), _n(b), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("name", NAMES)
def test_default_hyp_and_hyp_range_match(name):
    js, ts = jk.get_kernel(name), tk.get_kernel(name)
    rng = np.random.default_rng(4)
    x = rng.uniform(-2, 3, (50, 6))
    y = rng.standard_normal(50) * 3 + 1
    np.testing.assert_array_equal(ts.default_hyp(x, y), js.default_hyp(x, y))
    for a, b in zip(ts.hyp_range(x, y), js.hyp_range(x, y)):
        np.testing.assert_array_equal(a, b)
    assert ts.num_hyp(6) == js.num_hyp(6)
    assert ts.out_scale_idx == js.out_scale_idx


@pytest.mark.parametrize("name", NAMES)
def test_f32_in_gives_f32_out(name):
    """No constant promotes a float32 build to float64 (gp_tpu
    kernels_extra.py:43-47): float32 in, float32 out, for k, k_noise,
    diag_k and their cotangents."""
    ts = tk.get_kernel(name)
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.uniform(-2, 2, (30, 3)), dtype=torch.float32,
                     requires_grad=True)
    chyp = torch.tensor(_chyp(rng, name, 3), dtype=torch.float32,
                        requires_grad=True)
    sn2 = torch.tensor(0.01, dtype=torch.float32, requires_grad=True)
    K = ts.k(chyp, x, x[:7])
    Kn = ts.k_noise(chyp, sn2, x, 30)
    assert K.dtype == Kn.dtype == ts.diag_k(chyp, x).dtype == torch.float32
    for out, args in ((K, (chyp, x)), (Kn, (chyp, sn2, x))):
        grads = torch.autograd.grad(out.sum(), args)
        assert all(g.dtype == torch.float32 for g in grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scale", ["unit", "small_entries"])
@pytest.mark.parametrize("form,p1", FORMS)
def test_rounding_bound_per_form_passes_rounding_and_fails_a_wrong_build(
        dtype, scale, form, p1):
    """The kernel-vs-plain tolerance of each form: a build that differs
    only by rounding (the plain version in dtype against the float64
    one) stays inside it, near-coincident pairs included; a build off by
    1e-2 relative on one 16 x 16 tile does not, even where the entries
    are far below sf2."""
    m, n, d = 200, 150, 24
    g = torch.Generator().manual_seed(3)
    x1 = torch.rand(m, d, generator=g, dtype=torch.float64) * 4 - 2
    x2 = torch.rand(n, d, generator=g, dtype=torch.float64) * 4 - 2
    x2[:10] = x1[:10] + 1e-4 * torch.rand(10, d, generator=g,
                                          dtype=torch.float64)
    # sq ~ 2 (entries O(sf2)) or ~ 48 (entries ~ e^-15 sf2 for Matern)
    inv_l = 1.0 / x1.std(dim=0) / (d ** 0.5 if scale == "unit" else 1.0)
    sf2 = 1.3
    exact = se_tile.se_matrix_plain(inv_l, sf2, x1, x2, form, p1)
    c = lambda t: t.to(dtype)
    K = se_tile.se_matrix_plain(c(inv_l), sf2, c(x1), c(x2), form, p1)
    bound = se_tile.rounding_bound(c(inv_l), sf2, c(x1), c(x2), K, form,
                                   p1)
    assert bool(((K.double() - exact).abs() <= bound.double()).all())
    wrong = K.clone()
    wrong[:16, :16] *= 1 + 1e-2
    assert not bool(((wrong - K).abs() <= bound).all())
    # the bound sits far below a typical entry
    assert float((bound / K.abs()).median()) < 1e-2


def test_unknown_form_raises():
    x = torch.zeros(4, 2, dtype=torch.float64)
    for call in (lambda: se_tile.se_matrix(1.0, 1.0, x, x, form="m72"),
                 lambda: se_tile.se_matrix_diag(1.0, 1.0, x, torch.ones(4),
                                                form="exp"),
                 lambda: se_tile.cov_k("m12", True)):
        with pytest.raises(ValueError, match="form"):
            call()


def test_cpu_builds_of_every_form_launch_no_kernel():
    se_tile.reset_launches()
    x = torch.randn(20, 3, dtype=torch.float64)
    for name in NAMES:
        ts = tk.get_kernel(name)
        chyp = torch.zeros(ts.num_hyp(3), dtype=torch.float64)
        ts.k(chyp, x, x)
        ts.k_noise(chyp, 0.1, x, 20)
    assert all(c == 0 for by_form in se_tile.launches.values()
               for c in by_form.values())


@pytest.mark.parametrize("n_real", [40, 33])
def test_generic_k_noise_matches_gp_tpu(n_real):
    """A spec without a fused k_noise takes the generic build + diagonal
    scatter, and its vjp, as gp_tpu's get_k_noise gives them."""
    js = jk.get_kernel("matern52")._replace(k_noise=None)
    ts = tk.get_kernel("matern52")._replace(k_noise=None)
    rng = np.random.default_rng(11)
    n, d = 40, 3
    x = rng.standard_normal((n, d))
    chyp = _chyp(rng, "matern52", d)
    G = rng.standard_normal((n, n))
    G = G + G.T
    G[np.arange(n_real, n), np.arange(n_real, n)] = 0.0
    Kj, vjp = jax.vjp(lambda c, s: jk.get_k_noise(js)(c, s, x, n_real),
                      jnp.asarray(chyp), jnp.asarray(0.05))
    args = (_t(chyp, True), _t(0.05, True))
    Kt = tk.get_k_noise(ts)(*args, _t(x), n_real)
    np.testing.assert_allclose(_n(Kt), np.asarray(Kj), rtol=1e-12)
    for a, b in zip(torch.autograd.grad(Kt, args, _t(G)),
                    vjp(jnp.asarray(G))):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-10)
