"""The port's chain- and set-sharded products and its sharded evaluation and
LOOCV (``kde_tpu_torch/parallel/{product,eval}.py``,
``BatchedProductSampler(mesh=)``) over a 4-rank gloo world, mirroring
tests/test_sharding.py.

Keyed chain- and set-sharded results must be bitwise equal to the port's
unsharded keyed calls (every rank draws the unsharded streams and keeps its
rows), padding included.  In float64 ``sharded_log_eval`` and
``sharded_loo_entropy`` agree with the dense evaluation within rtol 1e-10
(another summation order), ``ksize_bandwidths_sharded`` with
``ksize_bandwidths`` and the JAX package's sharded program within rtol
1e-8 (a golden search stops on a tolerance, so ulp-level entropy
differences may move the last probe).

Worker mode: ``python tests/test_torch_sharding.py --worker <rank> <world>
<store> <out>`` (torch only; tests/torch_world.py)."""
import functools
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_world import assert_replicated, run_world  # noqa: E402
from torch_cpu import on_cpu  # noqa: E402,F401

KSIZE_MESHES = ("c2k2", "k4")


def _eval_data(dtype=np.float64):
    rng = np.random.default_rng(3)
    n, m, d = 64, 32, 3
    means = rng.normal(size=(n, d))
    var = rng.uniform(0.2, 1.0, size=(n, d))
    w = rng.uniform(size=n)
    q = rng.normal(size=(m, d))
    return [x.astype(dtype) for x in (q, means, var, w / w.sum())]


def _loo_data():
    rng = np.random.default_rng(4)
    n, d = 64, 2
    return rng.normal(size=(n, d)), np.full((n, d), 0.3), np.full(n, 1.0 / n)


LOO_ROUTES = ("dense", "f64", "f32")


def _loo_cases():
    """name -> (mesh, points, var, weights) of the sharded LOO entropy:
    64 2-D points with varied bandwidths and weights on the 2 x 2 mesh;
    the same with point 5 at zero weight (a zero-weight query row, and
    column); and one column a rank: 4 points on a 1 x 4 mesh, 2 on the
    2 x 2 (a rank whose one column is its row's own holds a fully masked
    row)."""
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(64, 2))
    var = rng.uniform(0.1, 0.5, size=(64, 2))
    w = rng.uniform(0.5, 1.5, size=64)
    w0 = w.copy()
    w0[5] = 0.0
    return {"varied": ("c2k2", pts, var, w / w.sum()),
            "zero_row": ("c2k2", pts, var, w0 / w0.sum()),
            "one_col_k4": ("c1k4", pts[:4], var[:4], w[:4] / w[:4].sum()),
            "one_col_c2k2": ("c2k2", pts[:2], var[:2], w[:2] / w[:2].sum())}


def _ksize_data():
    rng = np.random.default_rng(21)
    n, d = 205, 2                                  # 205 % 4 != 0: padding
    pts = rng.normal(size=(n, d)) * [1.0, 2.5]
    w = rng.uniform(0.5, 1.5, size=n)
    return pts, w / w.sum()


def _ksize_one_live():
    pts, _ = _ksize_data()
    w = np.zeros(len(pts))
    w[7] = 1.0
    return pts, w


def _ks_uniform_data():
    """Two 2-D densities for the kernel-sharded replay on the 2 x 2 mesh:
    density 0's point 5 has another bandwidth in dim 1, so at the leaves
    dim 1 is uniform on one kernels shard and not on the other; 13 points
    (padding on both shards' levels)."""
    rng = np.random.default_rng(14)
    n, n_out, n_iter = 13, 8, 2
    bw0 = np.full((2, n), 0.4)
    bw0[1, 5] = 0.55
    dens = [(rng.normal(size=(2, n)), bw0),
            (rng.normal(size=(2, n)) + 0.5, np.full((2, n), 0.3))]
    from fixtures import gibbs_streams
    ru, rn, _ = gibbs_streams(rng, 2, 2, n_out, n_iter, max(n, n_out))
    return dens, n_out, n_iter, ru, rn


def _circ_angles():
    rng = np.random.default_rng(5)
    a = np.mod(rng.normal(size=(1, 64)) * 0.3 + np.pi - 0.15 + np.pi,
               2 * np.pi) - np.pi
    b = np.mod(rng.normal(size=(1, 64)) * 0.3 - np.pi + 0.15 + np.pi,
               2 * np.pi) - np.pi
    return a, b


# ---------------------------------------------------------------------------
# worker side (torch only)
# ---------------------------------------------------------------------------

def _worker(argv):
    from torch_world import worker_finish, worker_setup
    rank, out = worker_setup(argv)
    import torch
    import kde_tpu_torch as kt
    kt.config.DEVICE = "cpu"          # a worker is no pytest process
    from kde_tpu_torch import config, manifolds as m
    from kde_tpu_torch.ops import kernels
    from kde_tpu_torch.parallel import (
        KERNELS, ksize_bandwidths_sharded, make_mesh, make_mesh_2d,
        prod_appx_ms_gibbs_kernel_sharded, prod_appx_ms_gibbs_sharded,
        product_sharded, sharded_log_eval, sharded_loo_entropy)
    f64 = torch.float64
    c4, c2k2 = make_mesh(4), make_mesh_2d((2, 2))
    meshes = {"c2k2": c2k2, "k4": make_mesh(axis_name=KERNELS)}
    res = {}
    rng = np.random.default_rng(0)
    dens = [kt.kde(rng.normal(size=(2, 64)), [0.4], dtype=f64)
            for _ in range(2)]

    # chain-sharded keyed product == the unsharded keyed call
    for name, n_out, ds, key in (("keyed", 64, dens, 42),
                                 ("padded", 50, [kt.kde(
                                     rng.normal(size=(1, 32)), [0.4],
                                     dtype=f64) for _ in range(2)], 0)):
        pts, idx = prod_appx_ms_gibbs_sharded(c4, n_out, ds, key=key)
        res[f"{name}/pts"], res[f"{name}/idx"] = pts.numpy(), idx.numpy()
        pts, idx = kt.prod_appx_ms_gibbs(n_out, ds, key=key, select="cdf")
        res[f"{name}/want_pts"] = pts.numpy()
        res[f"{name}/want_idx"] = idx.numpy()
    pts, _, diag = prod_appx_ms_gibbs_sharded(c4, 50, dens, diagnostics=True,
                                              key=1)
    res["diag/pts"] = pts.numpy()
    res["diag/mean"], res["diag/std"] = diag["mean"].numpy(), \
        diag["std"].numpy()
    # a generator key: rank 0's draw seeds every rank
    pts, _ = prod_appx_ms_gibbs_sharded(
        c4, 20, dens, key=torch.Generator().manual_seed(7 + rank))
    res["genkey/pts"] = pts.numpy()

    circ = dict(addop=(m.circular_add,), diffop=(m.circular_diff,),
                get_mu=(m.circular_mu,), get_lambda=(m.circular_lambda,))
    cd = [kt.kde(a, [0.2], dtype=f64, **circ) for a in _circ_angles()]
    pts, idx = prod_appx_ms_gibbs_sharded(c4, 64, cd, key=9)
    res["circ/pts"], res["circ/idx"] = pts.numpy(), idx.numpy()
    pts, idx = kt.prod_appx_ms_gibbs(64, cd, key=9, select="cdf", **circ)
    res["circ/want_pts"], res["circ/want_idx"] = pts.numpy(), idx.numpy()

    # sharded `*` == `*`: device-resident, hooks carried
    dev_dens = [kt.kde(torch.as_tensor(rng.normal(size=(2, 64))), [0.4])
                for _ in range(2)]
    pq = product_sharded(c4, dev_dens, key=1)
    want = kt.product(dev_dens, key=1)
    res["prod/flags"] = np.array([pq._host_points is None, pq._tree is None,
                                  pq.npts == 64])
    res["prod/pts"], res["prod/bw"] = pq.points.numpy(), pq.bw.numpy()
    res["prod/want_pts"], res["prod/want_bw"] = (want.points.numpy(),
                                                 want.bw.numpy())
    cq = product_sharded(c4, cd, key=2)
    res["prod/circ_hooks"] = np.array([cq.get_mu[0] is m.circular_mu])

    # set-sharded batch: 8 sets, 2 per rank
    sets = [[kt.kde(rng.normal(size=(2, 40)) + 0.1 * i, [0.3], dtype=f64),
             kt.kde(rng.normal(size=(2, 40)) + 0.5, [0.3], dtype=f64)]
            for i in range(8)]
    pts, idx = kt.BatchedProductSampler(sets, n_out=16, n_iter=2,
                                        mesh=c4).sample(5)
    res["batch/pts"], res["batch/idx"] = pts.numpy(), idx.numpy()
    pts, idx = kt.BatchedProductSampler(sets, n_out=16, n_iter=2).sample(5)
    res["batch/want_pts"], res["batch/want_idx"] = pts.numpy(), idx.numpy()
    got = kt.product_batched(sets, key=6, mesh=c4)
    want = kt.product_batched(sets, key=6)
    for name, ks in (("pbatch", got), ("pbatch/want", want)):
        res[f"{name}/pts"] = np.stack([k.points.numpy() for k in ks])
        res[f"{name}/bw"] = np.stack([k.bw.numpy() for k in ks])

    # evaluation and LOOCV
    res["eval"] = sharded_log_eval(c2k2, *(torch.as_tensor(x) for x in
                                           _eval_data())).numpy()
    q, mu, var, w = (torch.as_tensor(x) for x in _eval_data())
    res["eval_dead"] = sharded_log_eval(c2k2, q, mu, var,
                                        torch.zeros_like(w)).numpy()
    calls = []
    tiled = kernels.tiled_log_eval

    def counting(*a, **kw):
        calls.append(1)
        return tiled(*a, **kw)
    config.DIRECT_PAIR_LIMIT, kernels.tiled_log_eval = 1, counting
    res["eval_k1"] = sharded_log_eval(c2k2, *(torch.as_tensor(x) for x in
                                              _eval_data(np.float32))).numpy()
    res["eval_k1_calls"] = len(calls)
    config.DIRECT_PAIR_LIMIT, kernels.tiled_log_eval = 1 << 24, tiled
    res["loo"] = sharded_loo_entropy(
        c2k2, *(torch.as_tensor(x) for x in _loo_data())).numpy()
    # the LOO entropy's three routes: one block of local rows (the default
    # gate), and with the gate at 0 (a 1 x 1 shard too) query blocks of one
    # row in float64 and K1's wrapper in float32 (its twin on the CPU);
    # each rank's offset as eval.py hands it to log_eval_gated and as K1
    # gets it, and the rows of each dense block, gathered from every rank
    meshes["c1k4"] = make_mesh_2d((1, 4))
    gated, mixture = kernels.log_eval_gated, kernels.log_gauss_mixture
    seen = {"gated": [], "kernel": [], "rows": []}

    def recording(fn, key, arg):
        def wrapped(*a, **kw):
            seen[key].append(arg(a, kw))
            return fn(*a, **kw)
        return wrapped
    kernels.log_eval_gated = recording(gated, "gated",
                                       lambda a, kw: kw["loo_diag"])
    kernels.tiled_log_eval = recording(tiled, "kernel",
                                       lambda a, kw: kw["diag"])
    kernels.log_gauss_mixture = recording(mixture, "rows",
                                          lambda a, kw: a[0].shape[0])
    for case, (mesh_name, *data) in _loo_cases().items():
        for route in LOO_ROUTES:
            for key in seen:
                seen[key].clear()
            config.DIRECT_PAIR_LIMIT = 1 << 24 if route == "dense" else 0
            dt = torch.float32 if route == "f32" else f64
            res[f"loo/{case}/{route}"] = sharded_loo_entropy(
                meshes[mesh_name],
                *(torch.as_tensor(x, dtype=dt) for x in data)).numpy()
            for key, got in seen.items():
                every = [None] * 4
                torch.distributed.all_gather_object(every, list(got))
                res[f"loo/{case}/{route}/{key}"] = np.array(every,
                                                           dtype=np.int64)
    config.DIRECT_PAIR_LIMIT = 1 << 24
    kernels.tiled_log_eval = tiled
    kernels.log_eval_gated, kernels.log_gauss_mixture = gated, mixture
    # the sharded LOOCV search, its collectives counted where eval.py
    # calls them and the all-reduces they issue; "live1" weighs one point
    # only (its query has no live neighbour, so no probe's objective is
    # finite)
    from kde_tpu_torch.ops import sharded_loo
    from kde_tpu_torch.parallel import eval as par_eval
    calls, issued = [0], [0]

    def counted(fn, n=calls):
        def wrapped(*a, **kw):
            n[0] += 1
            return fn(*a, **kw)
        return wrapped
    saved = par_eval.psum, torch.distributed.all_reduce
    par_eval.psum = counted(saved[0])
    torch.distributed.all_reduce = counted(saved[1], issued)
    for name in KSIZE_MESHES:
        for case, (pts, w) in (("", _ksize_data()),
                               ("/live1", _ksize_one_live())):
            calls[0] = issued[0] = 0
            res[f"ksize{case}/{name}"] = ksize_bandwidths_sharded(
                meshes[name], pts, w, dtype=f64).numpy()
            res[f"ksize{case}/{name}/collectives"] = np.array(calls[0])
            res[f"ksize{case}/{name}/all_reduces"] = np.array(issued[0])
            res[f"ksize{case}/{name}/sweeps"] = np.array(
                sharded_loo.LAST["sweeps"])
    par_eval.psum, torch.distributed.all_reduce = saved
    res["eval_has_pmin"] = np.array(hasattr(par_eval, "pmin"))
    # NumPy inputs (on config.DEVICE) against the same calls on tensors
    for name, fn, data in (("eval", sharded_log_eval, _eval_data()),
                           ("loo", sharded_loo_entropy, _loo_data()),
                           ("ksize", ksize_bandwidths_sharded,
                            _ksize_data())):
        for kind, args in (("np", data),
                           ("t", [torch.as_tensor(x) for x in data])):
            got = fn(c2k2, *args)
            res[f"{kind}/{name}"] = got.numpy()
            res[f"{kind}/{name}/dev"] = np.array(got.device.type)

    # the kernel-sharded replay on the 2 x 2 mesh, and each rank's level
    # flags (taken once with its plan) against a check candidate by
    # candidate, gathered so that every rank holds all of them
    from kde_tpu_torch.parallel import gibbs_kernel_sharded as gks
    kdata, n_out, n_iter, ru, rn = _ks_uniform_data()
    kd = [kt.kde(p, b, dtype=f64) for p, b in kdata]
    ks = prod_appx_ms_gibbs_kernel_sharded(c2k2, n_out, kd, n_iter=n_iter,
                                           rand_u=ru, rand_n=rn,
                                           record_labels=True)
    for k, v in zip(("pts", "idx", "lab"), ks):
        res[f"ks2x2/{k}"] = v.numpy()
    plan = gks._get_ks_plan(kd, n_out, f64, 2,
                            c2k2.get_local_rank(KERNELS), kd[0].device)
    ok = True
    for l in range(1, plan.n_levels + 1):
        bw, flags = plan.level(l)[1][0], plan.level(l)[5]
        want = [[all(float(bw[j, i, k]) == float(bw[j, 0, k])
                     for i in range(bw.shape[1])) for k in range(2)]
                for j in range(2)]
        ok = ok and flags.tolist() == want
    flags = [torch.zeros_like(plan.lvl_uniform) for _ in range(4)]
    torch.distributed.all_gather(flags, plan.lvl_uniform)
    res["ks2x2/flags"] = torch.stack(flags).numpy()
    oks = [torch.zeros(1) for _ in range(4)]
    torch.distributed.all_gather(oks, torch.tensor([float(ok)]))
    res["ks2x2/flags_ok"] = torch.cat(oks).numpy()
    res["ks2x2/kernels_rank"] = np.array([0, 1, 0, 1])

    errors = []
    for fn in (lambda: make_mesh(3), lambda: make_mesh_2d((4, 2)),
               lambda: kt.BatchedProductSampler(sets[:6], n_out=16,
                                                mesh=c4),
               lambda: prod_appx_ms_gibbs_kernel_sharded(c4, 8, dens,
                                                         key=0),
               lambda: sharded_log_eval(c2k2, q[:31], mu, var, w)):
        try:
            fn()
            errors.append(False)
        except ValueError:
            errors.append(True)
    res["errors"] = np.array(errors)
    worker_finish(rank, out, res)


# ---------------------------------------------------------------------------
# pytest side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(os.path.abspath(__file__),
                     tmp_path_factory.mktemp("sharding"))


@pytest.fixture(scope="module")
def res(world):
    return world[0]


def test_every_rank_returns_the_same(world):
    assert_replicated(world)


@pytest.mark.parametrize("name", ["keyed", "padded", "circ"])
def test_chain_sharded_equals_unsharded_keyed(res, name):
    """n_out = 64, 50 (not a multiple of 4: padding) and a circular pair:
    bitwise the unsharded keyed call's labels and points."""
    np.testing.assert_array_equal(res[f"{name}/idx"],
                                  res[f"{name}/want_idx"])
    np.testing.assert_array_equal(res[f"{name}/pts"],
                                  res[f"{name}/want_pts"])
    if name == "circ":
        assert np.all(np.abs(res["circ/pts"]) <= np.pi)


def test_diagnostics_and_generator_key(res):
    """All-reduced moments over the 50 real chains; a generator key that
    differs per rank still gives every rank rank 0's product."""
    pts = res["diag/pts"]
    assert pts.shape == (2, 50)
    np.testing.assert_allclose(res["diag/mean"], pts.mean(axis=1),
                               rtol=1e-9)
    np.testing.assert_allclose(res["diag/std"], pts.std(axis=1), rtol=1e-9)
    assert res["genkey/pts"].shape == (2, 20)


def test_product_sharded_equals_product(res):
    """Device-resident (no host copy, no tree), sized at the mean count,
    bitwise `*` of the same key, and the circular hooks ride on the
    output (the JAX package's product_sharded drops them)."""
    assert res["prod/flags"].all()
    np.testing.assert_array_equal(res["prod/pts"], res["prod/want_pts"])
    np.testing.assert_array_equal(res["prod/bw"], res["prod/want_bw"])
    assert res["prod/circ_hooks"].all()


def test_set_sharded_batch_equals_unsharded(res):
    """BatchedProductSampler(mesh=) and product_batched(mesh=) over 8 sets
    (2 per rank): bitwise the unsharded batch's samples, labels and
    bandwidths."""
    for k in ("pts", "idx"):
        np.testing.assert_array_equal(res[f"batch/{k}"],
                                      res[f"batch/want_{k}"])
    for k in ("pts", "bw"):
        np.testing.assert_array_equal(res[f"pbatch/{k}"],
                                      res[f"pbatch/want/{k}"])


def test_sharded_log_eval_matches_dense_and_jax(res):
    import jax.numpy as jnp
    from kde_tpu.ops import kernels
    from kde_tpu.parallel.eval import sharded_log_eval
    from kde_tpu.parallel.mesh import make_mesh_2d
    q, means, var, w = (jnp.asarray(x) for x in _eval_data())
    np.testing.assert_allclose(
        res["eval"], np.asarray(kernels.log_eval(q, means, var, w)),
        rtol=1e-10)
    np.testing.assert_allclose(
        res["eval"], np.asarray(sharded_log_eval(make_mesh_2d((2, 2)), q,
                                                 means, var, w)), rtol=1e-10)
    assert np.all(np.isneginf(res["eval_dead"]))     # -inf, not NaN


def test_sharded_log_eval_k1_route(res):
    """With the gate at 1, each shard's float32 part takes the tiled route
    (K1's plain twin on the CPU); float32 sums in another order than the
    float64 dense reference, hence rtol = atol = 1e-5."""
    from kde_tpu.ops import kernels
    assert res["eval_k1_calls"] >= 1
    want = kernels.log_eval(*(x.astype(np.float64)
                              for x in _eval_data(np.float32)))
    np.testing.assert_allclose(res["eval_k1"], np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_sharded_loo_entropy_matches_dense(res):
    from kde_tpu.ops import kernels
    want = float(kernels.entropy_kernel(*_loo_data()))
    np.testing.assert_allclose(float(res["loo"]), want, rtol=1e-10)


@functools.lru_cache(maxsize=None)
def _jax_loo(case):
    from kde_tpu.parallel.eval import sharded_loo_entropy
    from kde_tpu.parallel.mesh import make_mesh_2d
    mesh, *data = _loo_cases()[case]
    shape = (1, 4) if mesh == "c1k4" else (2, 2)
    return float(sharded_loo_entropy(make_mesh_2d(shape), *data))


def _rank_offsets(mesh, n):
    """The offset each rank of the gloo mesh passes: its rows' start
    minus its columns' (ranks row-major over chains x kernels)."""
    c, k = (1, 4) if mesh == "c1k4" else (2, 2)
    return np.array([(r // k) * (n // c) - (r % k) * (n // k)
                     for r in range(4)])


@pytest.mark.parametrize("route", LOO_ROUTES)
@pytest.mark.parametrize("case", ["varied", "zero_row", "one_col_k4",
                                  "one_col_c2k2"])
def test_sharded_loo_entropy_matches_jax_sharded(res, case, route):
    """The port's LOO entropy on the gloo mesh against the JAX package's
    sharded program on its CPU mesh of the same shape, float64 at rtol
    1e-10 on the dense local rows and on K1's twin route (gate at 0), and
    float32 on K1's route at rtol = atol = 1e-5 (float32 sums against
    float64); finite where one rank's only column is its row's own."""
    got = float(res[f"loo/{case}/{route}"])
    want = _jax_loo(case)
    assert np.isfinite(got) and np.isfinite(want)
    tol = dict(rtol=1e-5, atol=1e-5) if route == "f32" else dict(rtol=1e-10)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("case", ["varied", "zero_row", "one_col_k4",
                                  "one_col_c2k2"])
def test_sharded_loo_entropy_routes_pass_the_offset(res, case):
    """Every rank hands ``log_eval_gated`` its rows' start minus its
    columns' as the LOO offset, nonzero on the off-diagonal ranks.  Above
    the gate in float32 K1 gets that offset (one call a rank) and no dense
    block is built; in float64 the rows go in blocks of one row (the gate
    at 0) and K1 is not called; below the gate each rank builds one block
    of all its rows."""
    mesh, pts = _loo_cases()[case][:2]
    offsets = _rank_offsets(mesh, len(pts))
    rows = len(pts) // (1 if mesh == "c1k4" else 2)
    assert offsets.any()
    for route in LOO_ROUTES:
        np.testing.assert_array_equal(res[f"loo/{case}/{route}/gated"],
                                      offsets[:, None])
    np.testing.assert_array_equal(res[f"loo/{case}/f32/kernel"],
                                  offsets[:, None])
    assert res[f"loo/{case}/f32/rows"].size == 0
    for route, blocks in (("f64", [1] * rows), ("dense", [rows])):
        assert res[f"loo/{case}/{route}/kernel"].size == 0
        np.testing.assert_array_equal(res[f"loo/{case}/{route}/rows"],
                                      np.array([blocks] * 4))


def test_sharded_loo_entropy_zero_weight_row_adds_nothing(res):
    """A zero-weight point adds no term of its own: the entropy equals
    the single-device one of the same weights (route by route), and it
    differs from the one with every point weighted."""
    from kde_tpu.ops import kernels
    _, pts, var, w = _loo_cases()["zero_row"]
    want = float(kernels.entropy_kernel(pts, var, w))
    for route in LOO_ROUTES:
        tol = (dict(rtol=1e-5, atol=1e-5) if route == "f32"
               else dict(rtol=1e-10))
        np.testing.assert_allclose(float(res[f"loo/zero_row/{route}"]), want,
                                   **tol)
    assert abs(float(res["loo/zero_row/dense"])
               - float(res["loo/varied/dense"])) > 1e-6


@pytest.mark.parametrize("mesh", KSIZE_MESHES)
def test_ksize_bandwidths_sharded_matches_dense(res, mesh):
    """N = 205 (padding) with non-uniform weights, on the 2-D mesh and a
    kernels-only mesh, against both packages' single-device search."""
    from kde_tpu.ops.loocv import ksize_bandwidths as jax_ksize
    from kde_tpu_torch.ops.loocv import ksize_bandwidths
    pts, w = _ksize_data()
    np.testing.assert_allclose(res[f"ksize/{mesh}"],
                               ksize_bandwidths(pts, w), rtol=1e-8)
    np.testing.assert_allclose(res[f"ksize/{mesh}"], jax_ksize(pts, w),
                               rtol=1e-8)


def _jax_meshes():
    import jax
    from jax.sharding import Mesh
    from kde_tpu.parallel import KERNELS, make_mesh_2d
    return {"c2k2": make_mesh_2d((2, 2)),
            "k4": Mesh(np.array(jax.devices()[:4]), (KERNELS,))}


@pytest.mark.parametrize("case", ["", "/live1"])
@pytest.mark.parametrize("mesh", KSIZE_MESHES)
def test_ksize_bandwidths_sharded_matches_jax_sharded(res, mesh, case):
    """The same search as the JAX package's sharded program on its own
    CPU mesh of the same shape, within rtol 1e-8, padding and non-uniform
    weights included; and where one point alone has weight (its query has
    no live neighbour: no probe's objective is finite, so both searches
    walk the same masked trajectory to the same pick)."""
    from kde_tpu.parallel import ksize_bandwidths_sharded
    pts, w = _ksize_one_live() if case else _ksize_data()
    want = np.asarray(ksize_bandwidths_sharded(_jax_meshes()[mesh], pts, w))
    np.testing.assert_allclose(res[f"ksize{case}/{mesh}"], want, rtol=1e-8)


@pytest.mark.parametrize("case", ["", "/live1"])
@pytest.mark.parametrize("mesh", KSIZE_MESHES)
def test_ksize_sharded_collectives_a_sweep(res, mesh, case):
    """One collective a sweep, the psum of its entropies over every rank
    of the mesh (the queries split over both axes, every column on each
    rank), counted where it is called, and one all-reduce a sweep issued,
    on the 2-D mesh and the kernels-only one alike; no pmin (the shift is
    local); the search stops one sweep after its last active one."""
    sweeps = int(res[f"ksize{case}/{mesh}/sweeps"])
    assert sweeps >= 3
    assert int(res[f"ksize{case}/{mesh}/collectives"]) == sweeps
    assert int(res[f"ksize{case}/{mesh}/all_reduces"]) == sweeps
    assert not bool(res["eval_has_pmin"])


@pytest.mark.parametrize("name", ["eval", "loo", "ksize"])
def test_numpy_inputs_equal_tensor_calls(res, name):
    """NumPy inputs to the three sharded functions land on config.DEVICE
    (the CPU in the workers) and give bitwise the tensor calls' results."""
    assert str(res[f"np/{name}/dev"]) == "cpu"
    np.testing.assert_array_equal(res[f"np/{name}"], res[f"t/{name}"])


def test_bad_meshes_and_shapes_raise(res):
    """ValueError for a mesh that does not match the world, a batch the
    mesh does not divide, a kernel-sharded product without a kernels
    axis, and query rows that do not divide the chains axis."""
    assert res["errors"].all(), res["errors"]


def test_no_process_group_raises():
    import kde_tpu_torch.parallel as par
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        par.make_mesh()
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        par.make_mesh_2d((1, 1))


def test_kernel_sharded_replay_matches_jax_on_2x2(res):
    """The kernel-sharded replay on the 2 x 2 gloo mesh equals the JAX
    package's kernel-sharded program on its 2 x 2 CPU mesh (labels exact,
    points within 1e-12: the same association), on densities whose leaf
    flags differ between the kernels shards; every rank's flags are those
    of a check candidate by candidate."""
    from kde_tpu import kde as jkde
    from kde_tpu.parallel import prod_appx_ms_gibbs_kernel_sharded as jks
    dens, n_out, n_iter, ru, rn = _ks_uniform_data()
    want = jks(_jax_meshes()["c2k2"], n_out, [jkde(p, b) for p, b in dens],
               n_iter=n_iter, rand_u=ru, rand_n=rn, record_labels=True)
    for k, w in zip(("pts", "idx", "lab"), want):
        if k == "pts":
            np.testing.assert_allclose(res["ks2x2/pts"], np.asarray(w),
                                       rtol=1e-12, atol=1e-14)
        else:
            np.testing.assert_array_equal(res[f"ks2x2/{k}"], np.asarray(w))
    assert res["ks2x2/flags_ok"].all()
    leaf = res["ks2x2/flags"][:, -1]                     # [rank, dn, d]
    assert leaf[:, :, 0].all() and leaf[:, 1].all()
    assert leaf[:, 0, 1].any() and not leaf[:, 0, 1].all()


if __name__ == "__main__" and "--worker" in sys.argv:
    _worker(sys.argv)
