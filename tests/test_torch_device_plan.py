"""The port's device-built product plan (ops/device_plan.py) against the JAX
package's and against the port's host plan.

Parity contract (kde_tpu/ops/device_plan.py): in 1-D with distinct values
the device hierarchy equals the host ball tree's; in d > 1 it is a
sort-based median-split hierarchy, which the port builds exactly as the
JAX package does (float64, rtol 1e-9: only summation order differs)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import kde_tpu  # noqa: E402
from fixtures import gibbs_streams  # noqa: E402
from kde_tpu.ops import device_plan as jdp  # noqa: E402
from kde_tpu.ops import gibbs as jgibbs  # noqa: E402
from kde_tpu_torch import kde as tkde  # noqa: E402
from kde_tpu_torch import kde_from_numpy, prod_appx_ms_gibbs, product  # noqa: E402
from kde_tpu_torch.ops import device_plan as tdp  # noqa: E402
from kde_tpu_torch.ops import gibbs as tgibbs  # noqa: E402
from kde_tpu_torch.ops.balltree import build_balltree  # noqa: E402

F64 = torch.float64
CPU = torch.device("cpu")


def _inputs(rng, n, d):
    pts = rng.normal(size=(n, d)) * np.linspace(1.0, 2.5, d)
    var = np.abs(rng.normal(size=(n, d))) + 0.1
    w = rng.uniform(0.5, 1.5, size=n)
    return pts, var, w / w.sum()


def _stats(pts, var, w):
    return [t.numpy() for t in tdp.device_tree_stats(
        *(torch.as_tensor(x) for x in (pts, var, w)))]


def _jax_stats(pts, var, w):
    return [np.asarray(t) for t in jdp.device_tree_stats(
        *(jnp.asarray(x) for x in (pts, var, w)))]


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 33, 100])
def test_device_stats_1d_equal_host_tree_and_jax(n):
    rng = np.random.default_rng(n)
    pts, var, w = _inputs(rng, n, 1)
    m, b, wt, perm = _stats(pts, var, w)
    t = build_balltree(pts, w, var)
    inner = max(n - 1, 1)
    np.testing.assert_allclose(m, t.means, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(b[:inner], t.bandwidth[:inner], rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(wt, t.weights, rtol=1e-12)
    np.testing.assert_array_equal(perm[n:], t.permutation[n:])
    jm, jb, jwt, jperm = _jax_stats(pts, var, w)
    np.testing.assert_allclose(m, jm, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(b, jb, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(wt, jwt, rtol=1e-12)
    np.testing.assert_array_equal(perm, jperm)


@pytest.mark.parametrize("n", [5, 16, 50, 257])
def test_device_stats_3d_equal_jax(n):
    rng = np.random.default_rng(n + 100)
    got = _stats(*_inputs(rng, n, 3))
    rng = np.random.default_rng(n + 100)
    want = _jax_stats(*_inputs(rng, n, 3))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(got[3], want[3])


def test_batched_stats_equal_per_set():
    """A leading set axis builds every set as it would be built alone."""
    rng = np.random.default_rng(3)
    sets = [_inputs(rng, 40, 2) for _ in range(3)]
    got = tdp.device_tree_stats(*(torch.stack([torch.as_tensor(s[i])
                                               for s in sets])
                                  for i in range(3)))
    for b, s in enumerate(sets):
        for g, w in zip(got, _stats(*s)):
            np.testing.assert_array_equal(g[b].numpy(), w)


def _port(jk):
    return kde_from_numpy(np.asarray(jk.points), np.asarray(jk.bw),
                          np.asarray(jk.weights), jk.multibandwidth,
                          dtype=F64)


def test_device_plan_3d_equals_jax():
    rng = np.random.default_rng(4)
    jd = [kde_tpu.kde(rng.normal(size=(3, n)), list(rng.uniform(0.3, 0.8, 3)))
          for n in (33, 20)]
    jp = jdp.DeviceProductPlan(jd, 16, jnp.float64)
    tp = tdp.DeviceProductPlan([_port(p) for p in jd], 16, F64)
    assert tp.offsets == list(jp.offsets) and tp.n_levels == jp.n_levels
    for name in ("t_mean", "t_bw", "lvl_mean", "lvl_bw", "lvl_logw"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(jp, name)),
                                   rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(tp.lvl_perm.numpy(),
                                  np.asarray(jp.lvl_perm))


@pytest.mark.parametrize("multibw", [False, True])
def test_device_plan_1d_equals_host_plan(multibw):
    """1-D: the device plan's level arrays equal the host plan's, so keyed
    products agree draw for draw."""
    rng = np.random.default_rng(9)
    bws = ([rng.uniform(0.2, 0.8, size=(1, 24)),
            rng.uniform(0.1, 0.5, size=(1, 17))] if multibw
           else [[0.4], [0.3]])
    dens = [tkde(rng.normal(size=(1, n)), bw, dtype=F64)
            for n, bw in zip((24, 17), bws)]
    assert dens[0].multibandwidth == multibw
    hp = tgibbs._ProductPlan(dens, 16, F64, CPU)
    dp = tdp.DeviceProductPlan(dens, 16, F64)
    assert hp.offsets == dp.offsets
    # the level arrays, and the roots the chains start from (unused slots
    # of t_bw hold 0 in the host tree and 1 here)
    for name in ("lvl_mean", "lvl_bw", "lvl_logw", "lvl_perm"):
        np.testing.assert_allclose(getattr(hp, name).numpy(),
                                   getattr(dp, name).numpy(),
                                   rtol=1e-9, atol=1e-12)
    for name in ("t_mean", "t_bw"):
        np.testing.assert_allclose(getattr(hp, name)[:, 0].numpy(),
                                   getattr(dp, name)[:, 0].numpy(),
                                   rtol=1e-9, atol=1e-12)
    out_h = prod_appx_ms_gibbs(16, dens, n_iter=2, key=2, plan="host")
    out_d = prod_appx_ms_gibbs(16, dens, n_iter=2, key=2, plan="device")
    np.testing.assert_array_equal(out_h[1].numpy(), out_d[1].numpy())
    np.testing.assert_allclose(out_h[0].numpy(), out_d[0].numpy(), rtol=1e-9)


def test_float32_zero_weight_stays_finite():
    """A zero-weight kernel gets the dtype's tiny as its floor, not
    log(0): its real level nodes keep a finite log-weight."""
    w = np.full(8, 1.0 / 7)
    w[3] = 0.0
    p = tkde(torch.as_tensor(np.arange(8.0)[None], dtype=torch.float32),
             [0.5], weights=torch.as_tensor(w, dtype=torch.float32))
    dp = tdp.DeviceProductPlan([p, p], 8, torch.float32)
    real = torch.as_tensor(np.isfinite(tgibbs._ProductPlan(
        [p, p], 8, torch.float32, CPU).lvl_logw.numpy()))
    assert torch.isfinite(dp.lvl_logw[real]).all()
    assert torch.isneginf(dp.lvl_logw[~real]).all()


def test_resolve_plan_impl_table():
    rng = np.random.default_rng(1)
    host = tkde(rng.normal(size=(2, 32)), [0.4], dtype=F64)
    dev = tkde(torch.as_tensor(rng.normal(size=(2, 32))), [0.4])
    treed = tkde(torch.as_tensor(rng.normal(size=(2, 32))), [0.4])
    treed.tree
    assert dev._host_points is None and dev._tree is None
    r = tgibbs._resolve_plan_impl
    assert r([host, treed], "auto", False) == "host"
    assert r([host, dev], "auto", False) == "device"
    assert r([host, dev], "auto", True) == "host"
    assert r([dev], "host", False) == "host"
    assert r([host], "device", False) == "device"
    with pytest.raises(ValueError, match="replay"):
        r([host], "device", True)
    with pytest.raises(ValueError, match="plan must be"):
        r([host], "bogus", False)
    # the JAX package routes a product's output and a host density alike
    jp = kde_tpu.kde(rng.normal(size=(2, 32)), [0.4])
    jpq = kde_tpu.product([jp, jp], key=kde_tpu.utils.random.ensure_key(0))
    for dens, tdens in (([jp, jp], [host, host]), ([jpq, jp], [dev, host])):
        for replay in (False, True):
            assert (r(tdens, "auto", replay)
                    == jgibbs._resolve_plan_impl(dens, "auto", replay))


def test_chained_product_never_builds_host_tree():
    rng = np.random.default_rng(2)
    p = tkde(rng.normal(size=(2, 32)), [0.5], dtype=F64)
    q = tkde(rng.normal(size=(2, 32)) + 0.2, [0.5], dtype=F64)
    r = tkde(rng.normal(size=(2, 32)) - 0.2, [0.5], dtype=F64)
    pq = product([p, q], key=3)
    pqr = product([pq, r], key=4)
    assert pq._tree is None and pq._host_points is None
    assert pqr._tree is None
    pts = pqr.get_points().numpy()
    assert np.all(np.isfinite(pts)) and np.abs(pts).max() < 6.0


def test_replay_with_device_plan_raises():
    rng = np.random.default_rng(6)
    dens = [tkde(rng.normal(size=(1, 8)), [0.5], dtype=F64) for _ in range(2)]
    ru, rn, _ = gibbs_streams(rng, 2, 1, 4, 2, 8)
    with pytest.raises(ValueError, match="replay"):
        prod_appx_ms_gibbs(4, dens, n_iter=2, rand_u=ru, rand_n=rn,
                           plan="device")
    # replay with plan="auto" takes the host plan even for a
    # device-resident density, and builds its tree
    d2 = [tkde(torch.as_tensor(p.points.T), [0.5]) for p in dens]
    prod_appx_ms_gibbs(4, d2, n_iter=2, rand_u=ru, rand_n=rn)
    assert all(p._tree is not None for p in d2)


def test_device_plan_product_moments():
    """Product of M unit Gaussians through the device plan passes the
    reference's moment brackets (test/runtests.jl:167-187) in at least 5 of
    10 keyed trials."""
    rng = np.random.default_rng(5)
    M, D, N = 3, 2, 100
    dens = [tkde(torch.as_tensor(rng.normal(size=(D, N))),
                 [1.0 / np.sqrt(N)] * D) for _ in range(M)]
    wins = 0
    for t in range(10):
        pts, _ = prod_appx_ms_gibbs(100, dens, n_iter=5, key=t, plan="device")
        pts = pts.numpy()
        prod_dev = np.sqrt(1.0 / M)
        wins += (np.linalg.norm(pts.mean(axis=1)) < prod_dev
                 and all(0.66 * prod_dev < pts[i].std() < 1.33 * prod_dev
                         for i in range(D)))
    assert wins >= 5
    assert all(p._tree is None for p in dens)
