"""gp_tpu_torch on a CUDA card: the tile kernel against its plain version.
The exact GP on the card against the same GP on the CPU is chip_smoke.py's
`cpu_parity` phase.

Every test here is marked `cuda` and skips without a CUDA device.  This
file imports neither jax nor gp_tpu, so it also runs where JAX is not
installed; there, skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from gp_tpu_torch.ops import se_tile

pytestmark = pytest.mark.cuda

SHAPES = [(1000, 777, 3), (333, 4097, 130), (64, 64, 24), (1, 65, 1)]


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
    assert torch.equal(K1.diagonal(), dvals)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,d", SHAPES)
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
