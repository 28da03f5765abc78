"""gp_tpu_torch covariance kernels against gp_tpu's, on the CPU in float64.

The same seeded numpy inputs go through the JAX function and its port.
K1/K2's plain versions are held against gp_tpu's Pallas kernels run in
interpret mode, as tests/test_pallas_kernels.py runs them.  Those kernels
ask for `preferred_element_type=float32` on the cross term
(pallas_kernels.py:76-81, 104-107), which rounds it to float32 even for
float64 inputs, so that comparison holds the float32 rounding bound of
the cross term and not float64 rounding.  The CUDA kernel itself is held
against its plain version in tests/test_torch_cuda.py (marker `cuda`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gp_tpu.ops.pallas_kernels as pk
from gp_tpu.ops import kernels as jk
from gp_tpu.ops import sdist as jsd
from gp_tpu.ops.sdist import sqdist as j_sqdist
from gp_tpu_torch.ops import kernels as tk
from gp_tpu_torch.ops import se_tile
from gp_tpu_torch.ops import sdist as tsd
from gp_tpu_torch.ops.sdist import sqdist as t_sqdist

SHAPES = [(70, 130, 5), (33, 33, 1), (257, 64, 24)]
SPECS = {"ard": (jk.SE_ARD, tk.SE_ARD), "iso": (jk.SE_ISO, tk.SE_ISO)}


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a, np.float64),
                        requires_grad=requires_grad)


def _n(t):
    return t.detach().cpu().numpy()


def _f32_cross_bound(a, b):
    """max |dK| / sf2 when the cross term a.b is rounded to float32:
    |d sq| <= 2 d eps32 (|a|^2 + |b|^2) summed over d terms, and
    |dK| <= sf2 |d sq| / 2."""
    d = a.shape[1]
    eps = float(np.finfo(np.float32).eps)
    return d * eps * ((a * a).sum(1).max() + (b * b).sum(1).max())


def _chyp(rng, which, d):
    return rng.uniform(-0.7, 0.7, d + 1 if which == "ard" else 2)


@pytest.mark.parametrize("m,n,d", SHAPES)
def test_sqdist_matches(m, n, d):
    rng = np.random.default_rng(0)
    x1, x2 = rng.standard_normal((m, d)), rng.standard_normal((n, d))
    np.testing.assert_allclose(_n(t_sqdist(_t(x1), _t(x2))),
                               np.asarray(j_sqdist(x1, x2)),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("m,n,d", SHAPES)
def test_sqdist_exact_and_vm_match(m, n, d):
    rng = np.random.default_rng(9)
    x1, x2 = rng.standard_normal((m, d)), rng.standard_normal((n, d))
    np.testing.assert_allclose(_n(tsd.sqdist_exact(_t(x1), _t(x2))),
                               np.asarray(jsd.sqdist_exact(x1, x2)),
                               rtol=1e-14)
    np.testing.assert_allclose(_n(tsd.sqdist_vm(_t(x1[0]), _t(x2))),
                               np.asarray(jsd.sqdist_vm(x1[0], x2)),
                               rtol=1e-14)


@pytest.mark.parametrize("which", ["ard", "iso"])
@pytest.mark.parametrize("m,n,d", SHAPES)
def test_k_and_diag_k_match(which, m, n, d):
    js, ts = SPECS[which]
    rng = np.random.default_rng(1)
    x1, x2 = rng.standard_normal((m, d)), rng.standard_normal((n, d))
    chyp = _chyp(rng, which, d)
    np.testing.assert_allclose(_n(ts.k(_t(chyp), _t(x1), _t(x2))),
                               np.asarray(js.k(chyp, x1, x2)),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(_n(ts.diag_k(_t(chyp), _t(x1))),
                               np.asarray(js.diag_k(chyp, x1)), rtol=1e-14)


@pytest.mark.parametrize("which", ["ard", "iso"])
@pytest.mark.parametrize("n_real", [140, 101])
def test_k_noise_matches(which, n_real):
    js, ts = SPECS[which]
    rng = np.random.default_rng(2)
    n, d = 140, 3
    x = rng.standard_normal((n, d))
    chyp = _chyp(rng, which, d)
    sn2 = 0.09
    np.testing.assert_allclose(
        _n(ts.k_noise(_t(chyp), sn2, _t(x), n_real)),
        np.asarray(js.k_noise(chyp, sn2, x, n_real)), rtol=1e-12, atol=0)


@pytest.mark.parametrize("which", ["ard", "iso"])
@pytest.mark.parametrize("n_real", [90, 77])
def test_k_noise_vjp_q_matches(which, n_real):
    js, ts = SPECS[which]
    rng = np.random.default_rng(3)
    n, d = 90, 4
    x = rng.standard_normal((n, d))
    chyp = _chyp(rng, which, d)
    sn2 = 0.05
    K = np.asarray(js.k_noise(chyp, sn2, x, n_real))
    Kinv = np.linalg.inv(K)
    alpha = rng.standard_normal(n)
    alpha[n_real:] = 0.0
    gj, trj = js.k_noise_vjp_q(chyp, sn2, x, n_real, K, Kinv, alpha)
    gt, trt = ts.k_noise_vjp_q(_t(chyp), _t(sn2), _t(x), n_real, _t(K),
                               _t(Kinv), _t(alpha))
    np.testing.assert_allclose(_n(gt), np.asarray(gj), rtol=1e-10)
    np.testing.assert_allclose(float(trt), float(trj), rtol=1e-10)


@pytest.mark.parametrize("which", ["ard", "iso"])
def test_default_hyp_and_hyp_range_match(which):
    js, ts = SPECS[which]
    rng = np.random.default_rng(4)
    x = rng.uniform(-2, 3, (50, 6))
    y = rng.standard_normal(50) * 3 + 1
    np.testing.assert_array_equal(ts.default_hyp(x, y), js.default_hyp(x, y))
    for a, b in zip(ts.hyp_range(x, y), js.hyp_range(x, y)):
        np.testing.assert_array_equal(a, b)
    assert ts.num_hyp(6) == js.num_hyp(6)
    assert ts.out_scale_idx == js.out_scale_idx


@pytest.mark.parametrize("m,n,d", SHAPES)
def test_plain_k2_matches_pallas_interpret(m, n, d):
    rng = np.random.default_rng(5)
    x1, x2 = rng.standard_normal((m, d)), rng.standard_normal((n, d))
    inv_l = np.exp(rng.uniform(-1, 1, d))
    K = pk.se_matrix(jnp.asarray(inv_l), 2.5, jnp.asarray(x1),
                     jnp.asarray(x2), interpret=True)
    Kt = se_tile.se_matrix_plain(_t(inv_l), 2.5, _t(x1), _t(x2))
    err = np.max(np.abs(_n(Kt) - np.asarray(K))) / 2.5
    assert err <= _f32_cross_bound(x1 * inv_l, x2 * inv_l)


@pytest.mark.parametrize("n,d", [(140, 3), (129, 7)])
def test_plain_k1_matches_pallas_interpret(n, d):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((n, d))
    inv_l = np.exp(rng.uniform(-0.3, 0.3, d))
    sf2 = 1.7
    dvals = np.where(np.arange(n) < n - 9, sf2 + 0.09, sf2)
    K = pk.se_matrix_diag(jnp.asarray(inv_l), sf2, jnp.asarray(x),
                          jnp.asarray(dvals), tile=128, interpret=True)
    Kt = se_tile.se_matrix_diag_plain(_t(inv_l), sf2, _t(x), _t(dvals))
    err = np.max(np.abs(_n(Kt) - np.asarray(K))) / sf2
    assert err <= _f32_cross_bound(x * inv_l, x * inv_l)
    # the diagonal is written, not computed: exact
    np.testing.assert_array_equal(np.diag(_n(Kt)), np.diag(np.asarray(K)))


@pytest.mark.parametrize("which", ["ard", "iso"])
def test_k_backward_matches_jax_vjp(which):
    fj = pk.seard_k_pallas if which == "ard" else pk.seiso_k_pallas
    ft = se_tile.seard_k if which == "ard" else se_tile.seiso_k
    rng = np.random.default_rng(7)
    m, n, d = 37, 29, 4
    x1, x2 = rng.standard_normal((m, d)), rng.standard_normal((n, d))
    chyp = _chyp(rng, which, d)
    G = rng.standard_normal((m, n))
    Kj, vjp = jax.vjp(fj, jnp.asarray(chyp), jnp.asarray(x1),
                      jnp.asarray(x2))
    gj = vjp(jnp.asarray(G))
    args = (_t(chyp, True), _t(x1, True), _t(x2, True))
    Kt = ft(*args)
    gt = torch.autograd.grad(Kt, args, _t(G))
    np.testing.assert_allclose(_n(Kt), np.asarray(Kj), rtol=1e-12)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-13)


@pytest.mark.parametrize("which", ["ard", "iso"])
@pytest.mark.parametrize("n_real", [64, 50])
def test_k_noise_backward_matches_jax_vjp(which, n_real):
    fj = pk.seard_k_noise_pallas if which == "ard" \
        else pk.seiso_k_noise_pallas
    ft = se_tile.seard_k_noise if which == "ard" else se_tile.seiso_k_noise
    rng = np.random.default_rng(8)
    n, d = 64, 3
    x = rng.standard_normal((n, d))
    chyp = _chyp(rng, which, d)
    sn2 = 0.07
    G = rng.standard_normal((n, n))
    G = G + G.T
    # cotangent contract: zero on the diagonal rows >= n_real
    G[np.arange(n_real, n), np.arange(n_real, n)] = 0.0
    Kj, vjp = jax.vjp(lambda c, s, xx: fj(c, s, xx, n_real),
                      jnp.asarray(chyp), jnp.asarray(sn2), jnp.asarray(x))
    gj = vjp(jnp.asarray(G))
    args = (_t(chyp, True), _t(sn2, True), _t(x, True))
    Kt = ft(*args, n_real)
    gt = torch.autograd.grad(Kt, args, _t(G))
    np.testing.assert_allclose(_n(Kt), np.asarray(Kj), rtol=1e-12)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-13)


def test_cpu_builds_launch_no_kernel():
    se_tile.reset_launches()
    x = torch.randn(20, 3, dtype=torch.float64)
    chyp = torch.zeros(4, dtype=torch.float64)
    tk.SE_ARD.k(chyp, x, x)
    tk.SE_ARD.k_noise(chyp, 0.1, x, 20)
    assert se_tile.launches == {w: dict.fromkeys(se_tile.FORMS, 0)
                                for w in ("se_matrix", "se_matrix_diag")}



@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scale", ["unit", "small_entries"])
@pytest.mark.parametrize("m,n,d", [(200, 150, 24), (64, 97, 130)])
def test_rounding_bound_passes_rounding_and_fails_a_wrong_build(dtype, scale,
                                                                 m, n, d):
    """The kernel-vs-plain tolerance: a build that differs only by
    rounding (the plain version in dtype against the float64 one) stays
    inside it; a build off by 1e-2 relative on one tile does not, even
    where the entries are ~e^-24 sf2 (at d = 24, inverse lengthscales
    1/std)."""
    g = torch.Generator().manual_seed(3)
    x1 = torch.rand(m, d, generator=g, dtype=torch.float64) * 4 - 2
    x2 = torch.rand(n, d, generator=g, dtype=torch.float64) * 4 - 2
    # sq ~ 2 (entries O(1)) or ~ 48 (entries ~ e^-24) at any d
    inv_l = 1.0 / x1.std(dim=0) / (d ** 0.5 if scale == "unit"
                                   else (d / 24) ** 0.5)
    sf2 = 1.3
    exact = se_tile.se_matrix_plain(inv_l, sf2, x1, x2)
    c = lambda t: t.to(dtype)
    K = se_tile.se_matrix_plain(c(inv_l), sf2, c(x1), c(x2))
    bound = se_tile.rounding_bound(c(inv_l), sf2, c(x1), c(x2), K)
    assert bool(((K.double() - exact).abs() <= bound.double()).all())
    wrong = K.clone()
    wrong[:16, :16] *= 1 + 1e-2
    assert not bool(((wrong - K).abs() <= bound).all())
    # the bound sits far below a typical entry
    assert float((bound / K.abs()).median()) < 1e-2
