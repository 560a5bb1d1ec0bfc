"""The port's batched serving path: the set axis of the chain,
``BatchedProductSampler`` and ``product_batched`` (``kde_tpu/ops/gibbs.py:
915-1135``).

The set axis is trace-exact against ``kde_tpu``: injected per-set streams
through the port's batched chain give, set by set, the labels of
``kde_tpu.prod_appx_ms_gibbs`` in replay mode and its points at rtol 1e-9
(float64).  Keyed, set ``i`` of a batch equals a standalone product keyed
with ``split(key, B)[i]`` in every selection mode, bit for bit on the CPU.
The batched refit's bandwidths match ``kde_tpu.kde`` of the same sample
points at rtol 1e-6 in float64; the float32 tiled route at rtol 1e-2, the
golden search's tolerance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import kde_tpu  # noqa: E402
from fixtures import gibbs_streams  # noqa: E402
import kde_tpu_torch as kt  # noqa: E402
from kde_tpu_torch import config as tconfig  # noqa: E402
from kde_tpu_torch.ops import gibbs as tgibbs  # noqa: E402
from kde_tpu_torch.ops import tiled_eval  # noqa: E402
from kde_tpu_torch.utils.random import split  # noqa: E402

F64 = torch.float64


def _port(jk):
    return kt.kde_from_numpy(np.asarray(jk.points), np.asarray(jk.bw),
                             np.asarray(jk.weights), jk.multibandwidth,
                             dtype=F64)


@pytest.mark.parametrize("cfg", [
    dict(d=2, ns=(10, 33), n_out=12, n_iter=2,
         masks=[[[True, True], [True, True]],
                [[True, False], [True, True]],
                [[False, True], [True, False]]]),
    dict(d=3, ns=(16, 16, 16), n_out=8, n_iter=1,
         masks=[[[True, True, False], [True, False, True], [False, True, True]],
                [[True, True, True], [True, True, True], [True, True, True]]]),
    dict(d=1, ns=(8, 8), n_out=8, n_iter=3, masks=None, B=3),
])
def test_set_axis_replay_trace_exact(cfg):
    d, ns, n_out, n_iter = cfg["d"], cfg["ns"], cfg["n_out"], cfg["n_iter"]
    masks = cfg["masks"]
    b = len(masks) if masks is not None else cfg["B"]
    dn = len(ns)
    rng = np.random.default_rng(17 + d)
    jsets = [[kde_tpu.kde(rng.normal(size=(d, n)) + 0.5 * i,
                          list(rng.uniform(0.3, 0.8, size=d))) for n in ns]
             for i in range(b)]
    plans = tgibbs._stack_plans([
        tgibbs._get_plan([_port(p) for p in js], n_out, F64,
                         torch.device("cpu")) for js in jsets])
    bu, bn = tgibbs._stream_sizes(dn, d, plans.n_levels, n_iter)
    streams = [gibbs_streams(rng, dn, d, n_out, n_iter, max(ns + (n_out,)))
               for _ in range(b)]
    u = torch.as_tensor(np.stack([s[0][:n_out * bu].reshape(n_out, bu)
                                  for s in streams]))
    nrm = torch.as_tensor(np.stack([s[1][:n_out * bn].reshape(n_out, bn)
                                    for s in streams]))
    mask = (torch.ones((b, dn, d), dtype=torch.bool) if masks is None
            else torch.as_tensor(masks))
    pts, idx, labels = tgibbs._gibbs_all_chains(u, nrm, plans, mask, n_iter,
                                                True)
    for i in range(b):
        pj, ij, lj = kde_tpu.prod_appx_ms_gibbs(
            n_out, jsets[i], n_iter=n_iter, rand_u=streams[i][0],
            rand_n=streams[i][1], record_labels=True,
            partial_dim_mask=None if masks is None else masks[i])
        np.testing.assert_array_equal(idx[i].numpy().T, np.asarray(ij))
        np.testing.assert_array_equal(labels[i].numpy().transpose(0, 2, 1),
                                      np.asarray(lj))
        np.testing.assert_allclose(pts[i].numpy().T, np.asarray(pj),
                                   rtol=1e-9, atol=1e-12)


def test_split():
    a = split(9, 4)
    assert a == split(9, 4) and len(set(a)) == 4 and a[:2] == split(9, 2)
    assert all(isinstance(s, int) and 0 <= s < 1 << 63 for s in a)
    g = torch.Generator().manual_seed(9)
    b = split(g, 3)
    assert b == split(torch.Generator().manual_seed(9), 3) != split(g, 3)
    kt.set_seed(5)
    c = split(None, 2)
    kt.set_seed(5)
    assert split(None, 2) == c


def _sets(rng, b=3, n=200, d=2, device_resident=False):
    """``b`` sets of two ``n``-component densities (leaves wider than 128,
    so ``blocked`` engages)."""
    def make(x):
        if device_resident:
            return kt.kde(torch.as_tensor(x), [0.4])
        return kt.kde(x, [0.4], dtype=F64)
    return [[make(rng.normal(size=(d, n)) + i), make(rng.normal(size=(d, n)))]
            for i in range(b)]


def _assert_set_equals_standalone(sampler, sets, key, select, **kw):
    pts, idx = sampler.sample(key, select=select)
    b = len(sets)
    assert pts.shape == (b, sets[0][0].ndim, sampler.n_out)
    assert idx.shape == (b, len(sets[0]), sampler.n_out)
    for i, seed in enumerate(split(key, b)):
        p1, i1 = kt.prod_appx_ms_gibbs(
            sampler.n_out, sets[i], n_iter=sampler.n_iter, key=seed,
            select=select,
            partial_dim_mask=None if sampler._masks_arg is None
            else sampler._masks_arg[i], **kw)
        np.testing.assert_array_equal(idx[i].numpy(), i1.numpy())
        np.testing.assert_array_equal(pts[i].numpy(), p1.numpy())


@pytest.mark.parametrize("select", ["cdf", "blocked", "gumbel"])
def test_batched_set_equals_standalone(select):
    rng = np.random.default_rng(21)
    sets = _sets(rng)
    s = kt.BatchedProductSampler(sets, n_out=64, n_iter=2)
    _assert_set_equals_standalone(s, sets, 9, select)


def test_batched_device_resident_sets():
    """Device-resident sets take the batched device plan; set i equals its
    standalone draw, which takes the single-set device plan."""
    rng = np.random.default_rng(22)
    sets = _sets(rng, b=2, device_resident=True)
    s = kt.BatchedProductSampler(sets, n_out=32, n_iter=2)
    _assert_set_equals_standalone(s, sets, 4, "cdf")
    assert all(p._tree is None for ds in sets for p in ds)


def test_mixed_sets_take_the_device_builder():
    rng = np.random.default_rng(23)
    host = _sets(rng, b=1)[0]
    dev = _sets(rng, b=1, device_resident=True)[0]
    s = kt.BatchedProductSampler([host, dev], n_out=32, n_iter=2)
    _assert_set_equals_standalone(s, [host, dev], 6, "cdf", plan="device")


def test_partial_dim_masks_and_refresh_keeps_them():
    rng = np.random.default_rng(24)
    sets = _sets(rng, b=2, n=40)
    masks = np.array([[[True, False], [False, True]],
                      [[True, True], [True, True]]])
    s = kt.BatchedProductSampler(sets, n_out=16, n_iter=2,
                                 partial_dim_masks=masks)
    _assert_set_equals_standalone(s, sets, 3, "cdf")
    new = _sets(rng, b=2, n=40)
    s.refresh(new)
    np.testing.assert_array_equal(s.mask.numpy(), masks)
    _assert_set_equals_standalone(s, new, 5, "gumbel")
    s.refresh(new, partial_dim_masks=None)
    assert bool(s.mask.all())


def test_rejects_bad_batches():
    rng = np.random.default_rng(25)
    sets = _sets(rng, b=2, n=16)
    bad = [kt.kde(rng.normal(size=(2, 8)), [0.4], dtype=F64)] * 2
    with pytest.raises(ValueError, match="share"):
        kt.BatchedProductSampler([sets[0], bad], n_out=16)
    with pytest.raises(ValueError, match="at least one"):
        kt.BatchedProductSampler([], n_out=16)
    with pytest.raises(ValueError, match="1-axis"):
        kt.BatchedProductSampler(sets, n_out=16, mesh=object())
    with pytest.raises(ValueError, match="1-axis"):
        kt.product_batched(sets, mesh=object())
    hooked = kt.kde(rng.normal(size=(2, 16)), [0.4], dtype=F64)
    hooked.addop = (lambda a, b: a - b,)
    # a hooked density beside a plain one in a set raises, as in JAX
    with pytest.raises(ValueError, match="manifold hooks"):
        kt.BatchedProductSampler([[hooked, sets[0][1]]], n_out=16)
    assert kt.product_batched([]) == []


@pytest.fixture
def jax_device_paths():
    """Pin the JAX package to its device paths (not its NumPy host paths),
    as tests/test_torch_slice.py does."""
    saved = kde_tpu.config.HOST_LOOCV_LIMIT
    kde_tpu.config.HOST_LOOCV_LIMIT = 0
    yield
    kde_tpu.config.HOST_LOOCV_LIMIT = saved


def test_product_batched_bandwidths_match_jax(jax_device_paths):
    rng = np.random.default_rng(26)
    sets = _sets(rng, b=3, n=120)
    outs = kt.product_batched(sets, key=1)
    assert len(outs) == 3
    for i, k in enumerate(outs):
        assert k.npts == 120 and k.ndim == 2 and k.dtype == F64
        assert k._host_points is None and k._tree is None
        pts = k.host_points()
        want = kde_tpu.kde(pts).host_bw_std()
        np.testing.assert_allclose(k.host_bw_std(), want, rtol=1e-6)
        np.testing.assert_allclose(k.weights.numpy(), 1.0 / 120, rtol=1e-15)
        # the refit is the single-product refit of the same points
        np.testing.assert_array_equal(k.bw.numpy(),
                                      kt.kde(k.get_points()).bw.numpy())
    np.testing.assert_array_equal(
        outs[0].get_points().numpy(),
        kt.BatchedProductSampler(sets, n_out=120).sample(1)[0][0].numpy())


def test_product_batched_tiled_route_f32(jax_device_paths, monkeypatch):
    """With LOOCV_PAIR_LIMIT at 1 the float32 refit takes the tiled route,
    on the CPU the kernel's plain twin (with its LOO mask)."""
    calls = []
    ref = tiled_eval.tiled_log_eval_ref

    def spy(*a, **k):
        calls.append(bool(k.get("loo", a[4] if len(a) > 4 else False)))
        return ref(*a, **k)
    monkeypatch.setattr(tiled_eval, "tiled_log_eval_ref", spy)
    monkeypatch.setattr(tconfig, "LOOCV_PAIR_LIMIT", 1)
    rng = np.random.default_rng(27)
    sets = [[kt.kde(rng.normal(size=(2, 150)) + s, [0.3],
                    dtype=torch.float32) for s in (0.0, 0.5)]
            for _ in range(2)]
    outs = kt.product_batched(sets, key=2)
    assert calls and all(calls) and tiled_eval.LAUNCHES == 0
    for k in outs:
        assert k.dtype == torch.float32
        want = kde_tpu.kde(k.host_points()).host_bw_std()
        np.testing.assert_allclose(k.host_bw_std(), want, rtol=1e-2)
