"""The port's multiscale Gibbs product.

Replay mode (injected streams) is trace-exact in float64 against both
``kde_tpu.prod_appx_ms_gibbs`` and the serial oracle
``kde_tpu.reference_impl.serial_gibbs_product``: labels equal, points to
rtol 1e-9 / atol 1e-12.  Keyed mode draws from torch generators, so it is
checked by its moments."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import kde_tpu  # noqa: E402
from fixtures import gibbs_streams  # noqa: E402
from kde_tpu.reference_impl import serial_gibbs_product  # noqa: E402
from kde_tpu_torch import (ProductSampler, kde_from_numpy,  # noqa: E402
                           prod_appx_ms_gibbs, product)
from kde_tpu_torch import kde as tkde  # noqa: E402
from kde_tpu_torch.ops import gibbs as tgibbs  # noqa: E402

F64 = torch.float64


def _port(jk):
    """The port's copy of a kde_tpu density."""
    return kde_from_numpy(np.asarray(jk.points), np.asarray(jk.bw),
                          np.asarray(jk.weights), jk.multibandwidth,
                          dtype=F64)


def _check_replay(jdens, n_out, n_iter, ru, rn, **kw):
    pts_s, idx_s, lab_s = serial_gibbs_product(
        [p.tree for p in jdens], n_out, n_iter, ru, rn, **kw)
    pts_j, idx_j, lab_j = kde_tpu.prod_appx_ms_gibbs(
        n_out, jdens, n_iter=n_iter, rand_u=ru, rand_n=rn,
        record_labels=True, **kw)
    pts_t, idx_t, lab_t = prod_appx_ms_gibbs(
        n_out, [_port(p) for p in jdens], n_iter=n_iter, rand_u=ru,
        rand_n=rn, record_labels=True, **kw)
    for idx_r, lab_r, pts_r in ((idx_s, lab_s, pts_s),
                                (np.asarray(idx_j), np.asarray(lab_j),
                                 np.asarray(pts_j))):
        np.testing.assert_array_equal(idx_t.numpy(), idx_r)
        np.testing.assert_array_equal(lab_t.numpy(), lab_r)
        np.testing.assert_allclose(pts_t.numpy(), pts_r, rtol=1e-9,
                                   atol=1e-12)
    return pts_t


@pytest.mark.parametrize("cfg", [
    dict(d=1, ns=(8, 8), n_out=8, n_iter=3),
    dict(d=2, ns=(16, 16, 16), n_out=8, n_iter=2),
    dict(d=3, ns=(10, 33), n_out=12, n_iter=1),   # ragged component counts
    dict(d=2, ns=(16, 16), n_out=8, n_iter=0),
])
def test_replay_trace_exact(cfg):
    rng = np.random.default_rng(7)
    d, ns, n_out, n_iter = cfg["d"], cfg["ns"], cfg["n_out"], cfg["n_iter"]
    dens = [kde_tpu.kde(rng.normal(size=(d, n)),
                        list(rng.uniform(0.3, 0.8, size=d))) for n in ns]
    ru, rn, _ = gibbs_streams(rng, len(ns), d, n_out, n_iter,
                              max(ns + (n_out,)))
    _check_replay(dens, n_out, n_iter, ru, rn)


def test_replay_partial_dims():
    rng = np.random.default_rng(8)
    d, n = 2, 16
    dens = [kde_tpu.kde(rng.normal(size=(d, n)) + s, [0.4, 0.4])
            for s in (5.0, 0.0, -5.0)]
    mask = np.array([[True, False], [True, True], [False, True]])
    ru, rn, _ = gibbs_streams(rng, 3, d, 8, 2, 16)
    _check_replay(dens, 8, 2, ru, rn, partial_dim_mask=mask)


def test_replay_no_entropy():
    rng = np.random.default_rng(9)
    dens = [kde_tpu.kde(rng.normal(size=(1, 8)), [0.5]) for _ in range(2)]
    ru, rn, _ = gibbs_streams(rng, 2, 1, 4, 3, 8)
    _check_replay(dens, 4, 3, ru, rn, add_entropy=False)


def test_replay_multibandwidth():
    rng = np.random.default_rng(11)
    d, n = 2, 16
    dens = [kde_tpu.kde(rng.normal(size=(d, n)),
                        rng.uniform(0.2, 0.8, size=(d, n)),
                        weights=rng.uniform(0.1, 1.0, size=n))
            for _ in range(2)]
    assert all(p.multibandwidth for p in dens)
    ru, rn, _ = gibbs_streams(rng, 2, d, 8, 2, 16)
    _check_replay(dens, 8, 2, ru, rn)


def test_replay_degenerate_far_apart():
    """~100 bandwidths apart: every selection takes the degenerate
    fallback (uniform draw) in all three engines."""
    rng = np.random.default_rng(31)
    d, n, n_out, n_iter = 1, 16, 10, 2
    dens = [kde_tpu.kde(rng.normal(size=(d, n)), [0.1]),
            kde_tpu.kde(rng.normal(size=(d, n)) + 100.0, [0.1])]
    ru, rn, _ = gibbs_streams(rng, 2, d, n_out, n_iter, max(n, n_out))
    _check_replay(dens, n_out, n_iter, ru, rn)


def test_chain_blocking_is_layout_only(monkeypatch):
    rng = np.random.default_rng(12)
    d, ns, n_out, n_iter = 2, (20, 30), 50, 2
    dens = [tkde(rng.normal(size=(d, n)), [0.4], dtype=F64) for n in ns]
    ru, rn, _ = gibbs_streams(rng, 2, d, n_out, n_iter, max(ns + (n_out,)))
    one = prod_appx_ms_gibbs(n_out, dens, n_iter=n_iter, rand_u=ru,
                             rand_n=rn, record_labels=True)
    monkeypatch.setattr(tgibbs, "CHAIN_BLOCK_BYTES", 1)
    plan = tgibbs._get_plan(dens, n_out, F64, torch.device("cpu"))
    assert tgibbs._chain_block(n_out, plan, 8) == 1
    blocked = prod_appx_ms_gibbs(n_out, dens, n_iter=n_iter, rand_u=ru,
                                 rand_n=rn, record_labels=True)
    for a, b in zip(one, blocked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_keyed_product_moments():
    """Two 1-D KDEs of 400 points from N(0, 1) and N(1, 1), bandwidth 0.1:
    the sample moments are held against the exact moments of the product
    mixture (a mixture over all 160,000 kernel pairs).  4,000 chains put
    the sample mean's standard error near 0.011; the brackets are about
    5 standard errors wide."""
    rng = np.random.default_rng(13)
    a = rng.normal(size=(1, 400))
    b = rng.normal(size=(1, 400)) + 1.0
    p = tkde(a, [0.1], dtype=F64)
    q = tkde(b, [0.1], dtype=F64)
    # exact product: pair (i, j) has weight ~ N(a_i; b_j, 2 s), mean
    # (a_i + b_j) / 2 and variance s / 2, with s = 0.1^2
    s = 0.01
    lw = -0.25 * (a[0][:, None] - b[0][None, :]) ** 2 / s
    w = np.exp(lw - lw.max())
    w /= w.sum()
    mu = (a[0][:, None] + b[0][None, :]) / 2
    mean = (w * mu).sum()
    var = (w * (mu ** 2 + s / 2)).sum() - mean ** 2
    pts, idx = prod_appx_ms_gibbs(4000, [p, q], n_iter=5, key=5)
    x = pts.numpy()[0]
    assert pts.shape == (1, 4000) and idx.shape == (2, 4000)
    assert idx.min() >= 0 and idx.max() < 400
    assert abs(x.mean() - mean) < 0.055
    assert 0.8 * var < x.var() < 1.25 * var


def test_keyed_reproducible_and_sampler():
    rng = np.random.default_rng(14)
    dens = [tkde(rng.normal(size=(2, 50)), [0.3], dtype=F64)
            for _ in range(2)]
    a = prod_appx_ms_gibbs(64, dens, n_iter=2, key=3)[0]
    b = prod_appx_ms_gibbs(64, dens, n_iter=2,
                           key=torch.Generator().manual_seed(3))[0]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    s = ProductSampler(dens, n_out=64, n_iter=2)
    c, lab = s.sample(3)
    np.testing.assert_array_equal(a.numpy(), c.numpy())
    assert lab.shape == (2, 64) and torch.isfinite(c).all()


def test_select_modes_and_hooks():
    rng = np.random.default_rng(15)
    dens = [tkde(rng.normal(size=(1, 20)), [0.3], dtype=F64)
            for _ in range(2)]
    for mode in ("auto", "size", "cdf", "blocked", "gumbel"):
        pts, idx = prod_appx_ms_gibbs(8, dens, key=0, select=mode)
        assert pts.shape == (1, 8) and torch.isfinite(pts).all()
        assert idx.min() >= 0 and idx.max() < 20
    with pytest.raises(ValueError, match="select"):
        prod_appx_ms_gibbs(8, dens, key=0, select="bogus")
    # explicit hooks run, as in JAX: a custom addop doing Euclidean
    # arithmetic draws exactly the hook-free product
    hooked = prod_appx_ms_gibbs(8, dens, key=0, addop=(lambda a, b: a + b,))
    plain = prod_appx_ms_gibbs(8, dens, key=0)
    for h, p in zip(hooked, plain):
        np.testing.assert_array_equal(h.numpy(), p.numpy())
    with pytest.raises(ValueError, match="BOTH"):
        prod_appx_ms_gibbs(8, dens, rand_u=np.zeros(1000))


def test_product_operator():
    """p * q: sized at the mean component count, refit, mode between the
    factors (reference src/MSGibbs01.jl:707-736)."""
    rng = np.random.default_rng(0)
    p = tkde(rng.normal(size=(2, 100)), [0.5], dtype=F64)
    q = tkde(rng.normal(size=(2, 80)) + 0.5, [0.5], dtype=F64)
    pq = p * q
    assert pq.npts == 90 and pq.ndim == 2
    pts = pq.get_points().numpy()
    assert np.all(np.abs(pts) < 6.0) and 0.0 < pts.mean() < 0.6
    assert torch.all(pq.bw > 0)
    r = product([p], add_entropy=False)
    np.testing.assert_array_equal(r.points.numpy(), p.points.numpy())
