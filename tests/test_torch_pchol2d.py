"""gp_tpu_torch's 2-D grid layer (parallel/pchol2d.py, multihost.py, the
grid routes of GP and the sharded checkpoint) under torch.distributed
against gp_tpu's on its virtual CPU devices (tests/conftest.py), in
float64.

One gloo world of 4 processes on a (2, 2) grid and one of 2 on a (1, 2)
grid (parallel.mesh.spawn), each running tests/torch_grid_programs.py
once; gp_tpu's functions are compiled at the one grid shape (2, 2) on 4
devices, and the (1, 2) world's values are the same functions'.  N = 60,
d = 3, block 8: N_pad 64 (8 panels), identity padding on every path.
gp_tpu's files (a grid save_model file, sharded directories of both
layouts) are written here while the worlds run, and read there.

Bounds: factor, L^-1 and K^-1 tiles at 1e-12 of their largest entry
(gathered with unblocked_layout_2d), the look-ahead factor bitwise equal
to the sequential one, the NLL at rtol 1e-10 and its gradient at 1e-7,
predictions at 1e-10, the grid fit's final f at rtol 1e-9 of gp_tpu's
single-device fit, the port's own checkpoints bit for bit.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import gp_tpu
from gp_tpu import SE_ARD
from gp_tpu.config import INF
from gp_tpu.models.base import default_hyps
from gp_tpu.parallel import pchol2d, pgp
from gp_tpu.parallel.mesh import make_mesh
from gp_tpu.utils import checkpoint as jck
from gp_tpu_torch.parallel import pchol2d as tp2
from gp_tpu_torch.parallel.mesh import spawn

import torch_grid_programs as programs

pytestmark = pytest.mark.dist

WORLDS = (4, 2)
BLOCK = programs.BLOCK
TIMEOUT = 150


def _grid_mesh():
    devs = np.asarray(jax.devices("cpu")[:4]).reshape(2, 2)
    return Mesh(devs, (pchol2d.AXR, pchol2d.AXC))


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(7)
    X = rng.uniform(-2, 2, (60, 3))
    y = np.sin(X[:, 0]) - 0.3 * X[:, 1] ** 2 + 0.05 * rng.standard_normal(60)
    Xd = X.copy()
    Xd[50:] = X[:10]                      # duplicated rows: a rescue
    hyp = default_hyps(SE_ARD, X, y, 1e-3, False)
    hyp = hyp + np.array([0.1, -0.2, 0.3, 0.1, 1.0, 0.0])
    bad = hyp.copy()
    bad[-2] = np.log(1e-300)              # sn2 = 0 and K ~ rank 1: not SPD
    bad[:3] = 10.0
    return {"X": X, "y": y, "Xd": Xd, "yd": np.sin(Xd[:, 0]), "hyp": hyp,
            "hyp_dup": np.array([0.0, 0.0, 0.0, 0.0, -30.0, 0.0]),
            "hyp_bad": bad, "xs": rng.uniform(-2, 2, (5, 3))}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("grid_checkpoints")
    shared = {"gp_tpu_file": str(d / "gp_tpu_grid.npz"),
              "gp_tpu_sharded_grid": str(d / "gp_tpu_sharded_grid"),
              "gp_tpu_sharded_rows": str(d / "gp_tpu_sharded_rows")}
    return {P: {**shared, "port_file": str(d / f"port{P}.npz"),
                "port_sharded_grid": str(d / f"port_sharded_grid{P}"),
                "port_sharded_rows": str(d / f"port_sharded_rows{P}")}
            for P in WORLDS}


@pytest.fixture(scope="module")
def worlds(request, prob, paths):
    """{P: future of each process's {"grid", "models"} results}: both
    worlds start at once, and gp_tpu's files are written while they run
    (the processes wait for them)."""
    pool = ThreadPoolExecutor(len(WORLDS))
    futures = {P: pool.submit(spawn, programs.run, P, "cpu", TIMEOUT,
                              (prob, paths[P])) for P in WORLDS}
    request.getfixturevalue("gp_tpu_files")
    yield futures
    pool.shutdown(wait=True)


def _res(worlds, P):
    return worlds[P].result(timeout=3 * TIMEOUT)


def _publish(write, path):
    """write(tmp) then rename to path: the processes wait for path."""
    tmp = path + ".part" + (".npz" if path.endswith(".npz") else "")
    write(tmp)
    os.replace(tmp, path)


@pytest.fixture(scope="module")
def gp_tpu_files(prob, paths):
    """gp_tpu's (2, 2) grid posterior at prob's hyps, saved by save_model
    and save_model_sharded, and a 2-device 1-D posterior saved sharded;
    returns pset_k2d's (hyp, L, invKys, ok)."""
    mesh = _grid_mesh()
    X, y = jnp.asarray(prob["X"]), jnp.asarray(prob["y"])
    hyp = jnp.asarray(prob["hyp"])
    files = paths[WORLDS[0]]
    post = pchol2d.pset_k2d(SE_ARD, hyp, X, y, mesh, block=BLOCK)
    g = gp_tpu.GP(prob["X"], prob["y"])
    g._hyps, g._post, g._post_dist, g._trained = post[0], None, \
        (mesh, BLOCK, post[1], post[2]), True
    _publish(lambda p: jck.save_model(g, p), files["gp_tpu_file"])
    _publish(lambda p: jck.save_model_sharded(g, p),
             files["gp_tpu_sharded_grid"])
    mesh1 = make_mesh(2)
    h1, L1, a1, _ = pgp.pset_k(SE_ARD, hyp, X, y, mesh1, block=BLOCK)
    g1 = gp_tpu.GP(prob["X"], prob["y"])
    g1._hyps, g1._post, g1._post_dist, g1._trained = h1, None, \
        (mesh1, BLOCK, L1, a1), True
    _publish(lambda p: jck.save_model_sharded(g1, p),
             files["gp_tpu_sharded_rows"])
    return post


@pytest.fixture(scope="module")
def ref(prob, gp_tpu_files):
    """gp_tpu's values on the (2, 2) grid."""
    mesh = _grid_mesh()
    X, y, xs = (jnp.asarray(prob[k]) for k in ("X", "y", "xs"))
    hyp = jnp.asarray(prob["hyp"])
    h, L, a, ok = gp_tpu_files
    out = {"pset_k2d": gp_tpu_files}

    def body(l4):
        W = pchol2d.pinv2d_local(l4[0, 0], 2, 2)
        return W[None, None], pchol2d.pkinv2d_local(W, 2, 2)[None, None]

    spec = P(pchol2d.AXR, pchol2d.AXC)
    out["W"], out["kinv"] = (np.asarray(t) for t in jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=spec, out_specs=(spec, spec),
        check_vma=False))(L))
    out["pnll_vg2d"] = pchol2d.pnll_vg2d(SE_ARD, hyp, X, y, mesh,
                                         block=BLOCK)
    out["pnll2d"] = pchol2d.pnll2d(SE_ARD, hyp, X, y, mesh, block=BLOCK)
    out["pnll2d_bad"] = pchol2d.pnll2d(SE_ARD, jnp.asarray(prob["hyp_bad"]),
                                       X, y, mesh, block=BLOCK)
    out["ppredict2d"] = pchol2d.ppredict2d(SE_ARD, h, X, L, a, xs, mesh)
    out["ppredict2d_with_grad"] = pchol2d.ppredict2d_with_grad(
        SE_ARD, h, X, L, a, xs, mesh)
    out["pset_k2d_rescue"] = pchol2d.pset_k2d(
        SE_ARD, jnp.asarray(prob["hyp_dup"]), jnp.asarray(prob["Xd"]),
        jnp.asarray(prob["yd"]), mesh, block=BLOCK)
    return out


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * np.abs(b).max())


def _gathered(res, key, index=None):
    """The processes' tiles of `key` in gp_tpu's global layout, as the
    dense (N_pad, N_pad) matrix."""
    tiles = {r["grid"]["rc"]: (r["grid"][key] if index is None
                               else r["grid"][key][index]) for r in res}
    pr = 1 + max(r for r, _ in tiles)
    pc = 1 + max(c for _, c in tiles)
    G = np.stack([np.stack([tiles[(r, c)] for c in range(pc)])
                  for r in range(pr)])
    return tp2.unblocked_layout_2d(G)


@pytest.mark.parametrize("pr,pc", [(1, 1), (2, 2), (1, 2), (2, 3)])
def test_layout_helpers_match_gp_tpu(pr, pc):
    n, B = 96, 4
    K = np.random.default_rng(pr * 10 + pc).standard_normal((n, n))
    Kb = tp2.blocked_layout_2d(K, pr, pc, B)
    np.testing.assert_array_equal(
        Kb, np.asarray(pchol2d.blocked_layout_2d(jnp.asarray(K), pr, pc, B)))
    np.testing.assert_array_equal(tp2.unblocked_layout_2d(Kb), K)
    for r in range(pr):
        for c in range(pc):
            np.testing.assert_array_equal(
                tp2.local_tiles(Kb, r, c).numpy(), Kb[r, c])
    for m in (60, 61, 96):
        assert tp2.pad_amount(m, pr, pc, B) == \
            pchol2d.pad_amount(m, pr, pc, B)


@pytest.mark.parametrize("P", WORLDS)
def test_factor_inverse_and_kinv_tiles(worlds, ref, P):
    res = _res(worlds, P)
    h, L, a, ok = ref["pset_k2d"]
    assert bool(ok)
    for r in res:
        hp, _, ap, okp = r["grid"]["pset_k2d"]
        assert okp
        np.testing.assert_array_equal(hp, np.asarray(h))
        _close(ap, np.asarray(a), 1e-10)
    Lj = np.tril(pchol2d.unblocked_layout_2d(L))
    _close(np.tril(_gathered(res, "pset_k2d", 1)), Lj, 1e-12)
    W = _gathered(res, "W")
    _close(W, pchol2d.unblocked_layout_2d(ref["W"]), 1e-12)
    _close(W, np.linalg.inv(Lj), 1e-12)
    _close(_gathered(res, "kinv"), pchol2d.unblocked_layout_2d(ref["kinv"]),
           1e-12)
    assert W.shape == (64, 64)


@pytest.mark.parametrize("P", WORLDS)
def test_lookahead_factor_is_bitwise_the_sequential_one(worlds, P):
    assert all(r["grid"]["lookahead_bitwise"] for r in _res(worlds, P))


@pytest.mark.parametrize("P", WORLDS)
def test_pnll_vg2d_matches_gp_tpu(worlds, ref, P):
    fj, gj = ref["pnll_vg2d"]
    vals = [r["grid"]["pnll_vg2d"] for r in _res(worlds, P)]
    for f, g in vals:
        np.testing.assert_allclose(f, float(fj), rtol=1e-10)
        _close(g, gj, 1e-7)
    assert all(f == vals[0][0] and np.array_equal(g, vals[0][1])
               for f, g in vals)


@pytest.mark.parametrize("P", WORLDS)
def test_pnll2d_value_and_inf_on_non_spd(worlds, ref, P):
    assert float(ref["pnll2d_bad"]) == INF
    for r in _res(worlds, P):
        np.testing.assert_allclose(r["grid"]["pnll2d"], float(ref["pnll2d"]),
                                   rtol=1e-10)
        assert r["grid"]["pnll2d_bad"] == INF


@pytest.mark.parametrize("P", WORLDS)
def test_pset_k2d_rescue_matches_gp_tpu(worlds, ref, P):
    hj, _, aj, okj = ref["pset_k2d_rescue"]
    assert bool(okj) and float(hj[-2]) > -30.0
    for r in _res(worlds, P):
        h, a, ok = r["grid"]["pset_k2d_rescue"]
        assert ok
        np.testing.assert_allclose(h[-2], float(hj[-2]), rtol=1e-12)
        # K is within rounding of singular there: alpha is not compared
        assert np.all(np.isfinite(a))


@pytest.mark.parametrize("P", WORLDS)
def test_ppredict2d_matches_gp_tpu(worlds, ref, P):
    for r in _res(worlds, P):
        for a, b in zip(r["grid"]["ppredict2d"], ref["ppredict2d"]):
            _close(a, b, 1e-10)
        for a, b in zip(r["grid"]["ppredict2d_with_grad"],
                        ref["ppredict2d_with_grad"]):
            _close(a, b, 1e-10)


@pytest.mark.parametrize("P", WORLDS)
def test_train_distributed_on_the_grid_matches_gp_tpu(worlds, prob, P):
    """From a fixed start: the final f at rtol 1e-9 of gp_tpu's
    single-device fit from the same start, the same on every process."""
    gj = gp_tpu.GP(prob["X"], prob["y"])
    fj = gj.train(init_hyps=prob["hyp"])
    res = _res(worlds, P)
    mu, s2 = gj.batch_predict(prob["xs"])
    for r in res:
        t = r["models"]["train"]
        np.testing.assert_allclose(t["f"], fj, rtol=1e-9)
        assert t["f"] == res[0]["models"]["train"]["f"]
        np.testing.assert_allclose(t["hyp"], np.asarray(gj.get_hyp()),
                                   rtol=1e-5, atol=1e-5)
        _close(t["pred"][0], mu, 1e-6)
        _close(t["pred"][1], s2, 1e-6)


@pytest.mark.parametrize("P", WORLDS)
def test_checkpoints_round_trip_bit_for_bit(worlds, P):
    """save_model -> load_model (pending) -> restore_distributed, and
    save_model_sharded -> load_model_sharded on the grid and on the 1-D
    mesh: every prediction bit for bit."""
    for r in _res(worlds, P):
        m = r["models"]
        assert m["pending"]
        for got in (m["reloaded"], m["sharded_grid"]):
            for a, b in zip(got, m["train"]["pred"]):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(*m["sharded_rows"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("P", WORLDS)
def test_a_mesh_of_another_layout_raises(worlds, P):
    for r in _res(worlds, P):
        mm = r["models"]["mismatch"]
        for k in ("restore_1d", "restore_other", "sharded_1d",
                  "sharded_other"):
            assert mm[k] is not None and "grid" in mm[k], (k, mm[k])
        assert "devices on axis 'rows'" in mm["sharded_rows_on_grid"]


@pytest.mark.parametrize("P", WORLDS)
def test_multihost_meshes(worlds, P):
    for r in _res(worlds, P):
        assert r["models"]["multihost"] == (True, (2, P // 2), P)


def test_gp_tpu_grid_file_restores_in_port(worlds, ref):
    """gp_tpu's (2, 2) grid save_model file and save_model_sharded
    directory, restored on the 4-process grid: predictions within 1e-10
    of gp_tpu's ppredict2d."""
    mu, s2 = ref["ppredict2d"]
    for r in _res(worlds, 4):
        for key in ("gp_tpu_file", "gp_tpu_sharded_grid"):
            a, b = r["models"][key]
            _close(a, mu, 1e-10)
            _close(b, s2, 1e-10)


def test_gp_tpu_sharded_rows_dir_loads_in_port(worlds, ref):
    """gp_tpu's 2-device 1-D sharded directory (all shards in
    shards_p0.npz), loaded on a 2-process "rows" mesh: the predictions of
    the same posterior, within 1e-10 of gp_tpu's grid ones."""
    mu, s2 = ref["ppredict2d"]
    for r in _res(worlds, 2):
        a, b = r["models"]["gp_tpu_sharded_rows"]
        _close(a, mu, 1e-10)
        _close(b, s2, 1e-10)


def test_port_grid_file_restores_in_gp_tpu(worlds, prob, paths):
    """The 4-process grid's save_model file, restored by gp_tpu on its
    (2, 2) grid: predictions within 1e-10 of the port's."""
    pred = _res(worlds, 4)[0]["models"]["train"]["pred"]
    j = jck.load_model(paths[4]["port_file"])
    j.restore_distributed(_grid_mesh())
    mu, s2 = j.batch_predict(prob["xs"])
    _close(mu, pred[0], 1e-10)
    _close(s2, pred[1], 1e-10)
