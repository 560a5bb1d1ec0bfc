"""The port's kernel/component-axis sharded Gibbs engine
(``kde_tpu_torch/parallel/gibbs_kernel_sharded.py``) over a 4-rank gloo
world, against the serial oracle and the JAX package's sharded engine on a
JAX mesh of the same shape (the configs of tests/test_kernel_sharded.py;
each replay config meets JAX on one of the two meshes, in turns, since
every JAX program compiles for seconds).

The ranks run every scenario once (meshes ``(4,)`` over ``kernels`` and
``(2, 2)`` over ``chains x kernels``) and write their results; the tests
then check them here.  In float64, under the same injected streams: labels
exactly equal to the oracle's and JAX's, points within rtol 1e-9 of the
oracle (its own summation order) and 1e-12 of JAX (the same association:
shard offset + local cumsum, then divide).

Worker mode: ``python tests/test_torch_kernel_sharded.py --worker <rank>
<world> <store> <out>`` (torch only; tests/torch_world.py)."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from fixtures import gibbs_streams  # noqa: E402
from torch_world import assert_replicated, run_world  # noqa: E402
from torch_cpu import on_cpu  # noqa: E402,F401

REPLAY = [dict(d=2, ns=(64, 64), n_out=8, n_iter=2),
          dict(d=1, ns=(48, 80), n_out=8, n_iter=3),    # ragged counts
          dict(d=3, ns=(33, 17), n_out=6, n_iter=1),    # widths not % 4
          dict(d=2, ns=(16, 16, 16), n_out=8, n_iter=0)]
MESHES = ("k4", "c2k2")


# ---------------------------------------------------------------------------
# inputs, made with numpy on both sides
# ---------------------------------------------------------------------------

def _replay_data(cfg):
    rng = np.random.default_rng(5)
    d, ns = cfg["d"], cfg["ns"]
    dens = [(rng.normal(size=(d, n)), list(rng.uniform(0.3, 0.8, size=d)))
            for n in ns]
    ru, rn, _ = gibbs_streams(rng, len(ns), d, cfg["n_out"], cfg["n_iter"],
                              max(ns + (cfg["n_out"],)))
    return dens, ru, rn


def _partial_data():
    rng = np.random.default_rng(6)
    d, n = 2, 32
    dens = [(rng.normal(size=(d, n)) + s, [0.4, 0.4]) for s in (5.0, 0.0,
                                                               -5.0)]
    mask = np.array([[True, False], [True, True], [False, True]])
    ru, rn, _ = gibbs_streams(rng, 3, d, 8, 2, n)
    return dens, mask, ru, rn


def _mesh2d_data():
    rng = np.random.default_rng(7)
    d, n, n_out, n_iter = 2, 40, 7, 2           # 7 chains: padding on 2
    dens = [(rng.normal(size=(d, n)), [0.5, 0.5]) for _ in range(2)]
    ru, rn, _ = gibbs_streams(rng, 2, d, n_out, n_iter, max(n, n_out))
    return dens, n_out, n_iter, ru, rn


def _ties_data():
    d, n, dn, n_out, n_iter = 2, 8, 2, 4, 1
    L = int(np.floor(np.log2(max(n, n_out)))) + 1
    bu = n_out * dn * (1 + L * (1 + n_iter))
    bn = n_out * d * (L + 1)
    eps = np.finfo(np.float64).eps
    boundary = np.array([0.125, 0.25, 0.5, 0.75, 0.875, 0.5 - eps / 2,
                         0.5 + eps, 0.25 + eps / 2, np.nextafter(1.0, 0.0),
                         eps])
    dens = [(np.zeros((d, n)), [0.5, 0.5]) for _ in range(dn)]
    return dens, n_out, n_iter, np.resize(boundary, bu), np.zeros(bn)


def _circular_data():
    rng = np.random.default_rng(11)
    n = 48
    ang = np.where(rng.uniform(size=n) < 0.5,
                   np.pi - 0.1 * rng.uniform(size=n),
                   -np.pi + 0.1 * rng.uniform(size=n))
    dens = [(np.vstack([ang + 0.02 * j, rng.normal(size=n)]), [0.3, 0.4])
            for j in range(2)]
    ru, rn, _ = gibbs_streams(rng, 2, 2, 8, 2, max(n, 8))
    return dens, ru, rn


def _collect_data():
    rng = np.random.default_rng(12)
    n = 32
    ang = np.pi - 0.05 * rng.uniform(size=n)
    ru, rn, _ = gibbs_streams(rng, 2, 1, 8, 2, max(n, 8))
    plain = rng.normal(size=(1, n))
    return ang, plain, ru, rn


def _far_data():
    rng = np.random.default_rng(37)
    d, n = 1, 64
    dens = [(rng.normal(size=(d, n)), [0.1]),
            (rng.normal(size=(d, n)) + 100.0, [0.1])]
    ru, rn, _ = gibbs_streams(rng, 2, d, 8, 2, max(n, 8))
    return dens, ru, rn


# ---------------------------------------------------------------------------
# worker side (torch only)
# ---------------------------------------------------------------------------

def _worker(argv):
    from torch_world import worker_finish, worker_setup
    rank, out = worker_setup(argv)
    import torch
    import torch.distributed as dist
    import kde_tpu_torch as kt
    kt.config.DEVICE = "cpu"          # a worker is no pytest process
    from kde_tpu_torch import manifolds as m
    from kde_tpu_torch.parallel import (KERNELS, make_mesh, make_mesh_2d,
                                        prod_appx_ms_gibbs_kernel_sharded)
    f64 = torch.float64
    meshes = {"k4": make_mesh(axis_name=KERNELS),
              "c2k2": make_mesh_2d((2, 2))}
    kde = lambda pts, bw, **h: kt.kde(pts, bw, dtype=f64, **h)
    res = {}

    def ks(name, mesh, n_out, dens, n_iter, **kw):
        out = prod_appx_ms_gibbs_kernel_sharded(meshes[mesh], n_out, dens,
                                                n_iter=n_iter, **kw)
        for k, v in zip(("pts", "idx", "lab"), out):
            res[f"{name}/{k}"] = v.numpy()

    for i, cfg in enumerate(REPLAY):
        dens, ru, rn = _replay_data(cfg)
        dens = [kde(*x) for x in dens]
        for mesh in MESHES:
            ks(f"replay{i}/{mesh}", mesh, cfg["n_out"], dens, cfg["n_iter"],
               rand_u=ru, rand_n=rn, record_labels=True)
    dens, mask, ru, rn = _partial_data()
    ks("partial", "k4", 8, [kde(*x) for x in dens], 2, rand_u=ru, rand_n=rn,
       partial_dim_mask=mask)
    dens, n_out, n_iter, ru, rn = _mesh2d_data()
    ks("mesh2d", "c2k2", n_out, [kde(*x) for x in dens], n_iter, rand_u=ru,
       rand_n=rn)
    dens, n_out, n_iter, ru, rn = _ties_data()
    ks("ties", "k4", n_out, [kde(*x) for x in dens], n_iter, rand_u=ru,
       rand_n=rn, record_labels=True)
    dens, ru, rn = _far_data()
    ks("far", "k4", 8, [kde(*x) for x in dens], 2, rand_u=ru, rand_n=rn,
       record_labels=True)

    circ = dict(addop=(m.circular_add,), diffop=(m.circular_diff,),
                get_mu=(m.circular_mu,), get_lambda=(m.circular_lambda,))
    dens, ru, rn = _circular_data()
    dens = [kde(*x, **circ) for x in dens]
    ks("circ", "k4", 8, dens, 2, rand_u=ru, rand_n=rn, record_labels=True,
       **circ)
    ks("circ_plain", "k4", 8, dens, 2, rand_u=ru, rand_n=rn, **circ)
    # the plain engine on the same streams, this rank alone
    p1 = kt.prod_appx_ms_gibbs(8, dens, n_iter=2, rand_u=ru, rand_n=rn,
                               record_labels=True, **circ)
    for k, v in zip(("pts", "idx", "lab"), p1):
        res[f"circ_single/{k}"] = v.numpy()

    ang, plain, ru, rn = _collect_data()
    p1 = kde(ang[None, :], [0.3], **circ)
    p2 = kde((-ang)[None, :], [0.3], **circ)
    ks("collect_auto", "k4", 8, [p1, p2], 2, rand_u=ru, rand_n=rn)
    ks("collect_expl", "k4", 8, [p1, p2], 2, rand_u=ru, rand_n=rn, **circ)
    try:
        prod_appx_ms_gibbs_kernel_sharded(meshes["k4"], 8,
                                          [p1, kde(plain, [0.3])], n_iter=2,
                                          rand_u=ru, rand_n=rn)
        res["collect_mixed_raised"] = False
    except ValueError:
        res["collect_mixed_raised"] = True

    # keyed: the streams of the unsharded keyed call, padded to the mesh
    rng = np.random.default_rng(8)
    dens = [kde(rng.normal(size=(2, 64)), [0.3]) for _ in range(2)]
    for mesh in MESHES:
        ks(f"keyed/{mesh}", mesh, 251, dens, 3, key=3)
    pk, ik = kt.prod_appx_ms_gibbs(251, dens, n_iter=3, key=3, select="cdf")
    res["keyed/single_pts"], res["keyed/single_idx"] = pk.numpy(), ik.numpy()

    # all_reduce is bitwise equal on every rank (the loops around the
    # collectives branch on its results)
    x = torch.as_tensor(np.random.default_rng(100 + rank).normal(size=1000))
    dist.all_reduce(x)
    res["allreduce_sum"] = x.numpy()
    res["ranks"] = np.array([meshes["c2k2"].get_local_rank("chains"),
                             meshes["c2k2"].get_local_rank("kernels")])
    worker_finish(rank, out, res)


# ---------------------------------------------------------------------------
# pytest side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(os.path.abspath(__file__),
                     tmp_path_factory.mktemp("kernel_sharded"))


@pytest.fixture(scope="module")
def res(world):
    return world[0]


def _jax_mesh(name):
    import jax
    from jax.sharding import Mesh
    from kde_tpu.parallel.mesh import KERNELS, make_mesh_2d
    if name == "k4":
        return Mesh(np.array(jax.devices()[:4]), (KERNELS,))
    return make_mesh_2d((2, 2))


def _jkde(pts, bw, **h):
    from kde_tpu import kde
    return kde(pts, bw, **h)


def _oracle(dens, n_out, n_iter, ru, rn, **kw):
    from kde_tpu.reference_impl import serial_gibbs_product
    return serial_gibbs_product([p.tree for p in dens], n_out, n_iter, ru,
                                rn, **kw)


def _jax_ks(mesh, n_out, dens, n_iter, **kw):
    from kde_tpu.parallel import prod_appx_ms_gibbs_kernel_sharded
    out = prod_appx_ms_gibbs_kernel_sharded(_jax_mesh(mesh), n_out, dens,
                                            n_iter=n_iter, **kw)
    return [np.asarray(x) for x in out]


def _check(res, name, want_pts, want_idx, want_lab=None, rtol=1e-9,
           atol=1e-12):
    np.testing.assert_array_equal(res[f"{name}/idx"], want_idx)
    if want_lab is not None:
        np.testing.assert_array_equal(res[f"{name}/lab"], want_lab)
    np.testing.assert_allclose(res[f"{name}/pts"], want_pts, rtol=rtol,
                               atol=atol)


def test_ranks_replicated_and_all_reduce_bitwise(world):
    assert_replicated(world, [k for k in world[0] if k != "ranks"])
    assert sorted(tuple(r["ranks"]) for r in world) == [(0, 0), (0, 1),
                                                        (1, 0), (1, 1)]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("i", range(len(REPLAY)))
def test_replay_parity(res, i, mesh):
    cfg = REPLAY[i]
    dens, ru, rn = _replay_data(cfg)
    dens = [_jkde(*x) for x in dens]
    pts_s, idx_s, lab_s = _oracle(dens, cfg["n_out"], cfg["n_iter"], ru, rn)
    _check(res, f"replay{i}/{mesh}", pts_s, idx_s, lab_s)
    if MESHES[i % 2] != mesh:
        return      # JAX's engine compiles for seconds: one mesh per config
    pts_j, idx_j, lab_j = _jax_ks(mesh, cfg["n_out"], dens, cfg["n_iter"],
                                  rand_u=ru, rand_n=rn, record_labels=True)
    _check(res, f"replay{i}/{mesh}", pts_j, idx_j, lab_j, rtol=1e-12,
           atol=1e-14)


def test_partial_dims(res):
    dens, mask, ru, rn = _partial_data()
    pts_s, idx_s, _ = _oracle([_jkde(*x) for x in dens], 8, 2, ru, rn,
                              partial_dim_mask=mask)
    _check(res, "partial", pts_s, idx_s)


def test_2d_mesh_with_chain_padding(res):
    dens, n_out, n_iter, ru, rn = _mesh2d_data()
    dens = [_jkde(*x) for x in dens]
    pts_s, idx_s, _ = _oracle(dens, n_out, n_iter, ru, rn)
    _check(res, "mesh2d", pts_s, idx_s)
    pts_j, idx_j = _jax_ks("c2k2", n_out, dens, n_iter, rand_u=ru, rand_n=rn)
    _check(res, "mesh2d", pts_j, idx_j, rtol=1e-12, atol=1e-14)


def test_exact_ties(res):
    dens, n_out, n_iter, ru, rn = _ties_data()
    pts_s, idx_s, lab_s = _oracle([_jkde(*x) for x in dens], n_out, n_iter,
                                  ru, rn)
    _check(res, "ties", pts_s, idx_s, lab_s)


def test_degenerate_far_apart(res):
    dens, ru, rn = _far_data()
    pts_s, idx_s, lab_s = _oracle([_jkde(*x) for x in dens], 8, 2, ru, rn)
    _check(res, "far", pts_s, idx_s, lab_s)


def test_circular_trace_exact(res):
    """Hooked sharded product == the port's plain engine == JAX's sharded
    engine under the same streams; the samples stay on the circle."""
    from kde_tpu import manifolds as mf
    circ = dict(addop=(mf.circular_add,), diffop=(mf.circular_diff,),
                get_mu=(mf.circular_mu,), get_lambda=(mf.circular_lambda,))
    _check(res, "circ", res["circ_single/pts"], res["circ_single/idx"],
           res["circ_single/lab"], rtol=1e-12, atol=1e-14)
    dens, ru, rn = _circular_data()
    pts_j, idx_j, lab_j = _jax_ks("k4", 8, [_jkde(*x, **circ) for x in dens],
                                  2, rand_u=ru, rand_n=rn,
                                  record_labels=True, **circ)
    _check(res, "circ", pts_j, idx_j, lab_j, rtol=1e-12, atol=1e-14)
    a = res["circ/pts"][0]
    assert np.all((a > -np.pi - 1e-9) & (a <= np.pi + 1e-9))


def test_collects_density_hooks(res):
    """Densities' circular hooks reach the engine without explicit hooks
    (the product mean sits at the wrap, not 0); mixing a hooked and a
    hook-free density raises ValueError."""
    np.testing.assert_array_equal(res["collect_auto/idx"],
                                  res["collect_expl/idx"])
    np.testing.assert_allclose(res["collect_auto/pts"],
                               res["collect_expl/pts"], rtol=1e-12,
                               atol=1e-14)
    assert np.all(np.abs(res["collect_auto/pts"][0]) > np.pi / 2)
    assert bool(res["collect_mixed_raised"])


@pytest.mark.parametrize("mesh", MESHES)
def test_keyed_equals_unsharded_keyed(res, mesh):
    """Keyed mode draws the unsharded keyed call's streams (251 chains,
    padded on the 2-way chain axis): finite, in range, and the same labels
    and points as ``prod_appx_ms_gibbs(key=3, select="cdf")``."""
    pts = res[f"keyed/{mesh}/pts"]
    assert pts.shape == (2, 251) and np.all(np.isfinite(pts))
    assert np.abs(pts.mean(axis=1)).max() < 1.0
    np.testing.assert_array_equal(res[f"keyed/{mesh}/idx"],
                                  res["keyed/single_idx"])
    np.testing.assert_allclose(pts, res["keyed/single_pts"], rtol=1e-12,
                               atol=1e-14)


def test_sizing_recommends_engine():
    """The routing rule: bigger products count more bytes, the shard
    count is ceil(bytes / budget), and a CPU device has no default
    budget."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch.parallel import (estimate_product_memory,
                                        recommend_shards)
    rng = np.random.default_rng(0)
    make = lambda n: [kt.kde(rng.normal(size=(2, n)), [0.2],
                             dtype=torch.float32) for _ in range(2)]
    small, big = make(128), make(1024)
    m_small = estimate_product_memory(small, n_out=64, n_iter=2)
    m_big = estimate_product_memory(big, n_out=64, n_iter=2)
    assert m_big["total"] > m_small["total"] > 0
    assert m_small["total"] == (m_small["args"] + m_small["temp"]
                                + m_small["out"])
    assert m_small["select"] == "cdf"
    r = recommend_shards(small, n_out=64, n_iter=2, mem=m_small,
                         hbm_budget=1 << 30)
    assert r == {"shards": 1, "engine": "plain", "bytes": m_small["total"],
                 "budget": 1 << 30, "select": "cdf"}
    r2 = recommend_shards(big, n_out=64, n_iter=2, mem=m_big,
                          hbm_budget=max(1, m_big["total"] // 3))
    assert r2["engine"] == "kernel-sharded" and r2["shards"] >= 3
    with pytest.raises(ValueError, match="hbm_budget"):
        recommend_shards(small, n_out=64, n_iter=2, mem=m_small)


if __name__ == "__main__" and "--worker" in sys.argv:
    _worker(sys.argv)
