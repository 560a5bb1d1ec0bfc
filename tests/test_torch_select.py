"""The keyed path's label selection modes (``kde_tpu/ops/gibbs.py:357-414,
658-690``) against the JAX package.

``blocked`` is the flat inverse-CDF draw restructured, so its labels equal
both ``kde_tpu``'s blocked draw and the port's flat draw for the same
uniforms in float64 (the ulp-wide tie window does not fire on these
inputs).  ``gumbel`` draws counter noise (utils/random.py), so it is held
to the softmax frequencies within 4 binomial standard errors and by
chi-square, and to the reference's moment brackets (test/runtests.jl:
167-187, as tests/test_device_plan.py checks them: at least 5 of 10
trials)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from kde_tpu import config as jconfig  # noqa: E402
from kde_tpu.ops import gibbs as jgibbs  # noqa: E402
from kde_tpu_torch import config as tconfig  # noqa: E402
from kde_tpu_torch import kde as tkde, prod_appx_ms_gibbs  # noqa: E402
from kde_tpu_torch.ops import gibbs as tgibbs  # noqa: E402

F64 = torch.float64


def _logits(rng, c, w):
    """``[c, w]`` float64 logits with -inf padding on a third of the rows
    and the degenerate-fallback shape (0 real / -inf padding) on the
    last."""
    lg = rng.normal(size=(c, w)) * 3.0
    pad = rng.integers(1, w + 1, size=c)
    lg[: c // 3] = np.where(np.arange(w)[None, :] < pad[: c // 3, None],
                            lg[: c // 3], -np.inf)
    lg[-1] = np.where(np.arange(w) < max(1, (2 * w) // 3), 0.0, -np.inf)
    return lg


@pytest.mark.parametrize("w", [5, 129, 1000, 5000])
def test_blocked_equals_jax_and_flat(w):
    rng = np.random.default_rng(w)
    c = 300
    lg = _logits(rng, c, w)
    u = rng.uniform(size=c)
    blk = tgibbs._blocked_block_size(w)
    got = tgibbs._select_label_blocked(torch.as_tensor(u),
                                       torch.as_tensor(lg), blk).numpy()
    flat = tgibbs._select_label(torch.as_tensor(u), torch.as_tensor(lg))
    want = jax.vmap(lambda uu, ll: jgibbs._select_label_blocked(uu, ll, blk))(
        jnp.asarray(u), jnp.asarray(lg))
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, flat.numpy())
    assert np.all(np.isfinite(np.take_along_axis(lg, got[:, None], 1)))


def test_blocked_block_size_equals_jax():
    got = [tgibbs._blocked_block_size(w) for w in range(1, (1 << 20) + 1)]
    want = [jgibbs._blocked_block_size(w) for w in range(1, (1 << 20) + 1)]
    assert got == want


def _chi2_ok(counts, p):
    """Pearson's chi-square of ``counts`` against probabilities ``p`` below
    its 0.999 quantile."""
    from scipy import stats
    want = counts.sum() * p
    return float(((counts - want) ** 2 / want).sum()) < stats.chi2.ppf(
        0.999, len(p) - 1)


def test_gumbel_frequencies_and_dead_row():
    for dtype in (F64, torch.float32):
        _gumbel_frequencies_and_dead_row(dtype)


def _gumbel_frequencies_and_dead_row(dtype):
    """2e5 draws of one row (chains 0..n-1 of one seed): frequencies within
    4 sigma of softmax and by chi-square; a dead row (0 / -inf) is uniform
    over its real candidates only, by chi-square, and so is a row that the
    degenerate fallback makes dead (logits near log(1e-99) - 40)."""
    n = 200_000
    p = np.array([0.5, 0.25, 0.125, 0.0625, 0.0625])
    logits = torch.as_tensor(np.log(p), dtype=dtype).expand(1, n, 5)
    seeds = torch.tensor([[0, 1]])
    z = tgibbs._select_label_gumbel(seeds, logits)[0].numpy()
    counts = np.bincount(z, minlength=5)
    freq = counts / n
    assert np.all(np.abs(freq - p) < 4 * np.sqrt(p * (1 - p) / n)), freq
    assert _chi2_ok(counts, p)
    dead = torch.tensor([0.0, -np.inf, 0.0, -np.inf, 0.0], dtype=dtype)
    z = tgibbs._select_label_gumbel(seeds, dead.expand(1, 30_000, 5),
                                    chain0=n, sel=3)[0]
    counts = np.bincount(z.numpy(), minlength=5)
    assert counts[1] == counts[3] == 0
    assert np.all(np.abs(counts[[0, 2, 4]] / 30_000 - 1 / 3)
                  < 4 * np.sqrt(2 / 9 / 30_000))
    assert _chi2_ok(counts[[0, 2, 4]], np.full(3, 1 / 3))
    # raw logits of a degenerate row: the fallback makes it uniform over
    # the real candidates, whatever their logits
    raw = torch.tensor([-300.0, -np.inf, -270.0, -285.0, -np.inf],
                       dtype=dtype)
    raw = raw.expand(1, 30_000, 5)
    assert bool(tgibbs._dead_predicate(raw).all())
    fb = tgibbs._apply_dead_fallback(raw, raw[:, 0], tgibbs._dead_predicate(
        raw))
    z = tgibbs._select_label_gumbel(seeds, fb, chain0=n, sel=4)[0]
    counts = np.bincount(z.numpy(), minlength=5)
    assert counts[1] == counts[4] == 0
    assert _chi2_ok(counts[[0, 2, 3]], np.full(3, 1 / 3))


def test_gumbel_noise_per_set_generator():
    """Set b's noise comes from seed b alone: a set's draws are the same
    whether it is drawn with others or alone."""
    lg = torch.zeros((3, 50, 40), dtype=F64)
    seeds = torch.tensor([[1, 0], [2, 0], [3, 0]])
    z = tgibbs._select_label_gumbel(seeds, lg)
    z1 = tgibbs._select_label_gumbel(seeds[1:2], lg[1:2])
    np.testing.assert_array_equal(z[1].numpy(), z1[0].numpy())
    assert not torch.equal(z[0], z[1])


_GRID = [(n_out, width, batch)
         for n_out in (1, 256, 512, 513, 1000, 4096, 16384)
         for width in (1, 128, 1000, 8191, 8192, 12288, 32768, 50000)
         for batch in (1, 2, 6, 7, 8, 12)]


@pytest.mark.parametrize("select", ["auto", "size", "cdf", "blocked",
                                    "gumbel"])
def test_resolve_select_table_equals_jax(select, monkeypatch):
    """With both packages' thresholds set alike, the routing tables agree
    on a grid of (select, n_out, width, batch)."""
    for name, value in (("GIBBS_SELECT", "size"),
                        ("SELECT_BLOCKED_WIDTH", 32768),
                        ("SELECT_BLOCKED_MAX_CHAINS", 512),
                        ("SELECT_GUMBEL_WIDTH", 8192),
                        ("SELECT_GUMBEL_BATCH", 8),
                        ("SELECT_GUMBEL_WORK", 8 << 20)):
        monkeypatch.setattr(tconfig, name, value)
        monkeypatch.setattr(jconfig, name, value)
    routes = set()
    for n_out, width, batch in _GRID:
        got = tgibbs.resolve_select(select, n_out, width, batch)
        assert got == jgibbs.resolve_select(select, n_out, width, batch)
        routes.add(got)
    assert tgibbs.resolve_select(select) == jgibbs.resolve_select(select)
    if select in ("auto", "size"):
        assert routes == {"cdf", "blocked", "gumbel"}
    for bad in ("bogus", "CDF"):
        with pytest.raises(ValueError):
            tgibbs.resolve_select(bad)
        with pytest.raises(ValueError):
            jgibbs.resolve_select(bad)


@pytest.mark.parametrize("select", ["blocked", "gumbel"])
def test_keyed_moment_brackets(select):
    """Product of M unit Gaussians (N = 300 components each, so leaves are
    wider than 128 and the blocked draw engages) passes the reference's
    moment brackets in at least 5 of 10 keyed trials."""
    rng = np.random.default_rng(5)
    M, D, N = 3, 2, 300
    dens = [tkde(torch.as_tensor(rng.normal(size=(D, N))),
                 [1.0 / np.sqrt(N)] * D) for _ in range(M)]
    wins = 0
    for t in range(10):
        pts, idx = prod_appx_ms_gibbs(100, dens, n_iter=5, key=t,
                                      select=select)
        pts = pts.numpy()
        assert np.all((idx.numpy() >= 0) & (idx.numpy() < N))
        prod_dev = np.sqrt(1.0 / M)
        wins += (np.linalg.norm(pts.mean(axis=1)) < prod_dev
                 and all(0.66 * prod_dev < pts[i].std() < 1.33 * prod_dev
                         for i in range(D)))
    assert wins >= 5


def test_blocked_keyed_product_identical_to_cdf():
    """blocked consumes the same stream slot as cdf, so in float64 the
    keyed product is label- and point-identical for the same key."""
    rng = np.random.default_rng(11)
    dens = [tkde(rng.normal(size=(2, 300)), [0.2], dtype=F64),
            tkde(rng.normal(size=(2, 300)) + 0.5, [0.2], dtype=F64)]
    pc, ic = prod_appx_ms_gibbs(200, dens, n_iter=3, key=7, select="cdf")
    pb, ib = prod_appx_ms_gibbs(200, dens, n_iter=3, key=7, select="blocked")
    np.testing.assert_array_equal(ic.numpy(), ib.numpy())
    np.testing.assert_array_equal(pc.numpy(), pb.numpy())


@pytest.mark.parametrize("select", ["blocked", "gumbel"])
def test_degenerate_fallback_uniform(select):
    """Densities 1000 bandwidths apart: every selection is degenerate and
    falls back to a uniform draw over the candidates (reference
    src/MSGibbs01.jl:311-315), which spreads the leaf labels widely."""
    rng = np.random.default_rng(47)
    n = 256
    dens = [tkde(rng.normal(size=(1, n)), [0.1], dtype=F64),
            tkde(rng.normal(size=(1, n)) + 1000.0, [0.1], dtype=F64)]
    pts, idx = prod_appx_ms_gibbs(512, dens, n_iter=2, key=5, select=select)
    assert torch.isfinite(pts).all()
    counts = np.bincount(idx.numpy()[0], minlength=n)
    assert (counts > 0).sum() > n * 0.5, counts
