"""gp_tpu_torch on a CUDA card: the tile kernel and the block Cholesky
kernels against their plain versions, and the blocked route against the
library factor and inverse.  The exact GP on the card against the same GP
on the CPU is chip_smoke.py's `cpu_parity` phase.

Every test here is marked `cuda` and skips without a CUDA device.  This
file imports neither jax nor gp_tpu, so it also runs where JAX is not
installed; there, skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from gp_tpu_torch.ops import chol, chol_block, se_tile

pytestmark = pytest.mark.cuda

# ragged and misaligned shapes (the scalar-store form), the tile edges
# (128 in float32, 64 in float64) at the main path's d = 24, and an even
# shape cut inside a tile (float64's 16-byte stores at a ragged edge)
SHAPES = [(1000, 777, 3), (333, 4097, 130), (64, 64, 24), (1, 65, 1),
          (128, 128, 24), (129, 255, 24), (256, 256, 24), (130, 194, 24)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(cuda, dtype, m, n, d):
    g = torch.Generator().manual_seed(0)
    x1 = torch.randn(m, d, generator=g, dtype=dtype).to(cuda)
    x2 = torch.randn(n, d, generator=g, dtype=dtype).to(cuda)
    inv_l = ((torch.rand(d, generator=g, dtype=dtype) + 0.5)
             / d ** 0.5).to(cuda)
    sf2 = torch.tensor(1.3, dtype=dtype, device=cuda)
    xs = x1[:min(m, n)]
    dvals = torch.full((xs.shape[0],), 1.4, dtype=dtype, device=cuda)
    return x1, x2, inv_l, sf2, xs, dvals


def _check_form(form, p1, x1, x2, inv_l, sf2, xs, dvals):
    se_tile.reset_launches()
    K = se_tile.se_matrix(inv_l, sf2, x1, x2, form, p1)
    K1 = se_tile.se_matrix_diag(inv_l, sf2, xs, dvals, form, p1)
    torch.cuda.synchronize()
    assert se_tile.launches["se_matrix"][form] == 1
    assert se_tile.launches["se_matrix_diag"][form] == 1
    # each entry within its own rounding bound (se_tile.rounding_bound)
    P = se_tile.se_matrix_plain(inv_l, sf2, x1, x2, form, p1)
    P1 = se_tile.se_matrix_diag_plain(inv_l, sf2, xs, dvals, form, p1)
    assert bool(((K - P).abs() <= se_tile.rounding_bound(
        inv_l, sf2, x1, x2, P, form, p1)).all())
    assert bool(((K1 - P1).abs() <= se_tile.rounding_bound(
        inv_l, sf2, xs, xs, P1, form, p1)).all())
    # K1 computes each symmetric pair once: exactly symmetric, with dvals
    # exactly on its diagonal
    assert torch.equal(K1.diagonal(), dvals)
    assert torch.equal(K1, K1.T)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,d", SHAPES + [(8000, 8000, 24)])
def test_kernel_matches_plain(cuda, dtype, m, n, d):
    _check_form("se", 1.0, *_inputs(cuda, dtype, m, n, d))


@pytest.mark.parametrize("form,p1", [("m52", 1.0), ("m32", 1.0),
                                     ("rq", 0.7), ("rq", 50.0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,d", SHAPES)
def test_kernel_form_matches_plain(cuda, form, p1, dtype, m, n, d):
    x1, x2, inv_l, sf2, xs, dvals = _inputs(cuda, dtype, m, n, d)
    x2[:min(m, n)] = x1[:min(m, n)]        # coincident pairs: r = 0 in K2
    alpha = torch.tensor(p1, dtype=dtype, device=cuda)
    _check_form(form, alpha, x1, x2, inv_l, sf2, xs, dvals)


def test_kernel_takes_inputs_that_require_grad(cuda):
    x1, x2, inv_l, sf2, xs, dvals = _inputs(cuda, torch.float32, 70, 66, 5)
    x1.requires_grad_(True)
    inv_l.requires_grad_(True)
    K = se_tile.se_matrix(inv_l, sf2, x1, x2)
    K1 = se_tile.se_matrix_diag(inv_l, sf2, x1, dvals[:1].expand(70))
    with torch.no_grad():
        assert torch.equal(K, se_tile.se_matrix(inv_l, sf2, x1, x2))
        assert torch.equal(K1, se_tile.se_matrix_diag(
            inv_l, sf2, x1, dvals[:1].expand(70)))


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.randn(8, 3, device=cuda)
    with pytest.raises(TypeError):
        se_tile.se_matrix(1.0, 1.0, x.half(), x.half())
    with pytest.raises(ValueError):
        se_tile.se_matrix(1.0, 1.0, x, x.double())
    with pytest.raises(ValueError):
        se_tile.se_matrix_diag(1.0, 1.0, x, torch.ones(5, device=cuda))
    with pytest.raises(ValueError):
        se_tile.se_matrix(1.0, 1.0, x, x, form="m72")
    with pytest.raises(ValueError):
        se_tile.se_matrix(1.0, 1.0, x, x, "rq", torch.ones(2, device=cuda))


# K = A A^T + b I is well conditioned (eigenvalues in [b, ~5b]); the f32
# plain versions are 3e-7 of max |L| from the f64 factor at b = 128 (on
# the CPU), so two f32 computations agree well inside 1e-5
CHOL_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _block_spd(cuda, dtype, b, seed=0):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(b, b, generator=g, dtype=torch.float64)
    return (A @ A.T + b * torch.eye(b, dtype=torch.float64)).to(cuda, dtype)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [1, 7, 32, 100, 128, 200])
def test_chol_inv_and_block_match_plain(cuda, dtype, b):
    K = _block_spd(cuda, dtype, b)
    chol_block.reset_launches()
    L, T = chol_block.chol_inv(K)
    L4 = chol_block.cholesky_block(K)
    torch.cuda.synchronize()
    # K3 by the register kernel up to the leaf's 128, the rank-1 loop above
    k3 = "chol_inv_reg" if b <= chol_block.K3_REG_MAX_B else "chol_inv"
    assert chol_block.launches == {"chol_inv_reg": 0, "chol_inv": 0,
                                   "chol": 1, "chol_panel": 0, k3: 1}
    Lp, Tp = chol_block.chol_inv_plain(K)
    assert _rel(L, Lp) <= CHOL_TOL[dtype]
    assert _rel(T, Tp) <= CHOL_TOL[dtype]
    assert _rel(L4, chol_block.cholesky_block_plain(K)) <= CHOL_TOL[dtype]
    assert not bool(torch.triu(L, 1).any() or torch.triu(T, 1).any()
                    or torch.triu(L4, 1).any())
    # a block of a larger matrix is read in place, through its row stride
    big = torch.zeros(b + 7, b + 7, dtype=dtype, device=cuda)
    big[3:3 + b, 5:5 + b] = K
    Lv, Tv = chol_block.chol_inv(big[3:3 + b, 5:5 + b])
    assert torch.equal(Lv, L) and torch.equal(Tv, T)
    assert torch.equal(chol_block.cholesky_block(big[3:3 + b, 5:5 + b]), L4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,w", [(32, 32), (128, 32), (128, 128),
                                 (256, 64), (128, 16), (200, 100),
                                 (1024, 32), (1024, 128), (1024, 256)])
def test_chol_panel_matches_plain(cuda, dtype, b, w):
    """K5 at one panel (the leaf alone), at several, at a width that does
    not fill the panel solve's compiled one (16, 100), and above the
    leaf's 128 (256 runs as panels of 128); one count of its C entry per
    call."""
    K = _block_spd(cuda, dtype, b, seed=1)
    chol_block.reset_launches()
    L = chol_block.cholesky_panel(K, w)
    torch.cuda.synchronize()
    assert chol_block.launches["chol_panel"] == 1
    assert _rel(L, chol_block.cholesky_panel_plain(K, w)) <= CHOL_TOL[dtype]
    assert not bool(torch.triu(L, 1).any())
    big = torch.zeros(b + 5, b + 5, dtype=dtype, device=cuda)
    big[5:, 5:] = K
    assert torch.equal(chol_block.cholesky_panel(big[5:, 5:], w), L)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bad", [0, 20, 127])
def test_chol_kernels_nan_on_indefinite(cuda, dtype, bad):
    """A failing pivot gives NaN from its column on, in K3 (the register
    kernel at b = 128), K4 and K5; the leading rows stay as the plain
    version has them."""
    K = _block_spd(cuda, dtype, 128)
    K[bad, bad] = -1e3
    chol_block.reset_launches()
    L, T = chol_block.chol_inv(K)
    assert chol_block.launches["chol_inv_reg"] == 1
    Lp, Tp = chol_block.chol_inv_plain(K)
    for F, P in ((L, Lp), (T, Tp)):
        assert torch.equal(torch.isnan(F), torch.isnan(P))
        if bad:
            assert _rel(F[:bad], P[:bad]) <= CHOL_TOL[dtype]
    for F in (L, T, chol_block.cholesky_block(K),
              chol_block.cholesky_panel(K, 16)):
        assert bool(torch.isnan(F[bad:, bad]).all())
        assert bool(torch.isnan(F[-1, -1]))
        assert not bool(chol.chol_ok(F))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,w,bad", [(128, 32, 0), (128, 32, 20),
                                     (128, 32, 127), (1024, 32, 0),
                                     (1024, 32, 200), (1024, 32, 1023),
                                     (1024, 128, 0), (1024, 128, 200),
                                     (1024, 128, 1023)])
def test_cholesky_panel_nan_mask(cuda, dtype, b, w, bad):
    """K5's NaN mask equals its plain version's: a pivot failing in the
    first panel, inside a later one and in the last; nothing NaN above
    the diagonal and the columns before the pivot as the plain version
    has them."""
    K = _block_spd(cuda, dtype, b, seed=7)
    K[bad, bad] = -1e3
    L = chol_block.cholesky_panel(K, w)
    P = chol_block.cholesky_panel_plain(K, w)
    assert torch.equal(torch.isnan(L), torch.isnan(P))
    assert not bool(torch.triu(L, 1).any())
    if bad:
        assert _rel(L[:, :bad], P[:, :bad]) <= CHOL_TOL[dtype]
    assert not bool(chol.chol_ok(L))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [1, 7, 128, 129, 200, 256, 1000, 1024])
def test_cholesky_block_matches_plain(cuda, dtype, b):
    """K4 in both forms: the register kernel up to 128, the blocked form
    above it (full and ragged last panels); one count of its C entry per
    call, however many kernels it launched."""
    K = _block_spd(cuda, dtype, b, seed=2)
    chol_block.reset_launches()
    L = chol_block.cholesky_block(K)
    torch.cuda.synchronize()
    assert chol_block.launches == {"chol_inv_reg": 0, "chol_inv": 0,
                                   "chol": 1, "chol_panel": 0}
    assert _rel(L, chol_block.cholesky_block_plain(K)) <= CHOL_TOL[dtype]
    assert not bool(torch.triu(L, 1).any())
    # a misaligned block of a larger matrix, read in place
    big = torch.zeros(b + 7, b + 7, dtype=dtype, device=cuda)
    big[3:3 + b, 5:5 + b] = K
    assert torch.equal(chol_block.cholesky_block(big[3:3 + b, 5:5 + b]), L)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,bad", [(128, 0), (128, 20), (128, 127),
                                   (1024, 0), (1024, 200), (1024, 1023)])
def test_cholesky_block_nan_mask(cuda, dtype, b, bad):
    """K4's NaN mask equals its plain version's: the register kernel at
    b = 128, the blocked form at 1024 (pivot 200 fails inside the second
    panel, 1023 in the last leaf); nothing NaN above the diagonal and the
    columns before the pivot as the plain version has them."""
    K = _block_spd(cuda, dtype, b, seed=7)
    K[bad, bad] = -1e3
    L = chol_block.cholesky_block(K)
    P = chol_block.cholesky_block_plain(K)
    assert torch.equal(torch.isnan(L), torch.isnan(P))
    assert not bool(torch.triu(L, 1).any())
    if bad:
        assert _rel(L[:, :bad], P[:, :bad]) <= CHOL_TOL[dtype]
    assert not bool(chol.chol_ok(L))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blocked_route_matches_library(cuda, dtype):
    """N = 2100 on the blocked route (padded to 3072: three panels of
    eight K3 leaves) against the library route; and the default route:
    library below chol._BLOCKED_MIN_N, blocked from it (N + 52 pads to
    seven panels, 56 leaves)."""
    def spd(n):
        g = torch.Generator(device=cuda).manual_seed(3)
        A = torch.randn(n, n, generator=g, dtype=torch.float64, device=cuda)
        return (A @ A.T / n + torch.eye(n, dtype=torch.float64,
                                        device=cuda)).to(dtype)
    K = spd(2100)
    chol_block.reset_launches()
    Lb, Ki = chol.factor_and_inverse(K, blocked=True)
    torch.cuda.synchronize()
    assert chol_block.launches["chol_inv_reg"] == 24
    Lr, Kir = chol.factor_and_inverse(K)
    assert sum(chol_block.launches.values()) == 24
    assert torch.equal(Lr, chol.library_cholesky(K))
    assert torch.equal(Kir, torch.cholesky_inverse(Lr))
    assert _rel(torch.tril(Lb), Lr) <= 100 * CHOL_TOL[dtype]
    assert _rel(Ki, Kir) <= 100 * CHOL_TOL[dtype]
    n = chol._BLOCKED_MIN_N + 52
    K = spd(n)
    chol_block.reset_launches()
    L = chol.cholesky(K)
    torch.cuda.synchronize()
    assert chol_block.launches["chol_inv_reg"] == 8 * (-(-n // 1024))
    assert _rel(L, chol.library_cholesky(K)) <= 100 * CHOL_TOL[dtype]


def test_chol_wrappers_reject_what_the_kernels_do_not_take(cuda):
    K = torch.eye(8, device=cuda)
    with pytest.raises(TypeError):
        chol_block.chol_inv(K.half())
    with pytest.raises(ValueError):
        chol_block.cholesky_panel(K, 3)
    with pytest.raises(ValueError):
        chol_block.cholesky_block(torch.ones(4, 5, device=cuda))


# the sparse models' K2 shapes: Kxu and K(X*, U) ragged against the tile,
# Kuu square, and the main shapes (N = 8000, M = 512, d = 24), float64
SPARSE_SHAPES = [(300, 40, 5), (40, 40, 5), (1000, 512, 24), (8000, 512, 24),
                 (512, 512, 24)]


@pytest.mark.parametrize("m,n,d", SPARSE_SHAPES)
def test_kernel_f64_at_sparse_shapes(cuda, m, n, d):
    x1, x2, inv_l, sf2, _, _ = _inputs(cuda, torch.float64, m, n, d)
    se_tile.reset_launches()
    K = se_tile.se_matrix(inv_l, sf2, x1, x2)
    torch.cuda.synchronize()
    assert se_tile.launches["se_matrix"]["se"] == 1
    P = se_tile.se_matrix_plain(inv_l, sf2, x1, x2)
    assert bool(((K - P).abs() <= se_tile.rounding_bound(
        inv_l, sf2, x1, x2, P)).all())


def _sparse_problem(n=400, m=40, d=5):
    import numpy as np
    rng = np.random.default_rng(3)
    X = rng.uniform(-2, 2, (n, d))
    y = np.sin(X[:, 0]) + 0.3 * X[:, 1] * X[:, 2] + 0.1 * rng.standard_normal(n)
    return X, y, X[-m:]


@pytest.mark.parametrize("chunk", [1, 4])
def test_batch_objective_matches_one_candidate(cuda, chunk):
    """The search's chunk objective (GP._multistart_objective) against
    the one-candidate objective, float64, N = 400: one K1 launch per
    candidate, the same INF set and values."""
    import numpy as np
    from gp_tpu_torch import GP
    from gp_tpu_torch.models import exact
    X, y, _ = _sparse_problem()
    gp = GP(X, y, dtype=torch.float64)
    h0 = gp._hyp_to_std(gp.get_default_hyps())
    vecs = h0 + np.random.default_rng(0).uniform(-1, 1, (chunk, h0.size))
    vecs[0, -2] += 8.0 if chunk > 1 else 0.0    # sn2 > mean(sf2): INF
    V = gp._tensor(vecs)
    se_tile.reset_launches()
    batch = gp._multistart_objective()(V)
    torch.cuda.synchronize()
    assert se_tile.launches["se_matrix_diag"]["se"] == chunk
    one = torch.stack([exact.multistart_objective(gp.kernel, False, v,
                                                  gp._x, gp._ys) for v in V])
    assert torch.equal(torch.isinf(batch), torch.isinf(one))
    fin = torch.isfinite(one)
    assert bool(fin.any())
    assert torch.allclose(batch[fin], one[fin], rtol=1e-10, atol=0)


@pytest.mark.parametrize("model", ["FITC", "VFE"])
def test_sparse_nll_card_matches_cpu(cuda, model):
    """FITC / VFE on the card against the CPU, float64: NLL and gradient
    at rtol 1e-10 (relative to the largest entry), K2 launches only."""
    import numpy as np
    import gp_tpu_torch
    X, y, U = _sparse_problem()
    cls = getattr(gp_tpu_torch, model)
    out = {}
    for dev in ("cuda", "cpu"):
        m = cls(X, y, device=dev)
        m.set_inducing(U)
        assert m.dtype == torch.float64
        vec = m._tensor(m._hyp_to_std(m.get_default_hyps() + 0.1))
        se_tile.reset_launches()
        f, g = m._objective_closure()(vec)
        out[dev] = (float(f), g.cpu().numpy())
        if dev == "cuda":
            assert se_tile.launches["se_matrix"]["se"] == 2
            assert se_tile.launches["se_matrix_diag"]["se"] == 0
    (fc, gc), (fh, gh) = out["cuda"], out["cpu"]
    assert abs(fc - fh) <= 1e-10 * abs(fh)
    assert np.max(np.abs(gc - gh)) <= 1e-10 * np.max(np.abs(gh))


@pytest.mark.parametrize("form,p1", [("se", 1.0), ("m52", 1.0), ("rq", 0.7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_keeps_nan_of_infinite_inverse_lengthscale(cuda, form, p1,
                                                          dtype):
    """An overflowed 1/lengthscale (inf) gives the plain version's NaN
    entries, not finite ones: the start with length scales at -200 must
    be INF on the card as on the CPU (the global search's entry)."""
    x1, x2, inv_l, sf2, xs, dvals = _inputs(cuda, dtype, 130, 70, 3)
    inv_l[0] = float("inf")
    alpha = torch.tensor(p1, dtype=dtype, device=cuda)
    for K, P in ((se_tile.se_matrix(inv_l, sf2, x1, x2, form, alpha),
                  se_tile.se_matrix_plain(inv_l, sf2, x1, x2, form, alpha)),
                 (se_tile.se_matrix_diag(inv_l, sf2, xs, dvals, form, alpha),
                  se_tile.se_matrix_diag_plain(inv_l, sf2, xs, dvals, form,
                                               alpha))):
        assert bool(torch.isnan(P).any())
        assert torch.equal(torch.isnan(K), torch.isnan(P))
        fin = ~torch.isnan(P)           # 0 (sq = inf) or dvals
        assert torch.equal(K[fin], P[fin])
