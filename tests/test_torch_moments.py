"""The keyed Gibbs product against the analytic product Gaussian: the
moment-bracket grid of tests/test_gibbs.py:15-50 (the reference's
testProds / rangeTestProds, test/runtests.jl:167-201) on the port.

The product of M standard-normal D-dim KDEs (LOOCV bandwidths) must have
a sample mean within one product std-dev of 0 and per-dim std-devs within
[0.66, 1.33] of it, in at least 5 of 10 trials.  Trial seeds derive from
17 and 23 through ``utils.random.split``, so the run is deterministic.  The
sharded keyed products are held bitwise to this keyed path
(tests/test_torch_sharding.py), and this grid holds the path to the
analytic product, with cdf (the default) and with gumbel."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

from kde_tpu_torch import kde, prod_appx_ms_gibbs  # noqa: E402
from kde_tpu_torch.utils.random import split  # noqa: E402


def _test_prods(seed, D=3, M=6, N=100, n=100, dev=1.0, mcmc=5,
                select="auto"):
    """One trial of the reference's testProds (test/runtests.jl:167-182)."""
    data_seed, key = split(seed, 2)
    rng = np.random.default_rng(data_seed)
    dens = [kde(dev * rng.normal(size=(D, N)), dtype=torch.float64)
            for _ in range(M)]
    pts, _ = prod_appx_ms_gibbs(n, dens, n_iter=mcmc, key=key, select=select)
    pts = pts.numpy()
    assert np.abs(pts).sum() > 1e-14
    prod_dev = np.sqrt(dev ** (2 * M) / (M * dev ** 2))
    t1 = np.linalg.norm(pts.mean(axis=1)) < 1.0 * prod_dev
    t2 = all(0.66 * prod_dev < pts[i].std() < 1.33 * prod_dev
             for i in range(D))
    return t1 and t2


def _range_test(seed, **kw):
    """>= 5 of 10 trials pass (reference rangeTestProds,
    test/runtests.jl:184-187)."""
    return sum(_test_prods(s, **kw) for s in split(seed, 10)) >= 5


@pytest.mark.parametrize("cfg", [
    dict(D=2, M=2), dict(D=2, M=4), dict(D=2, M=6),
    dict(D=3, M=6, mcmc=10),
    dict(D=3, M=5, N=300),
    dict(D=3, M=2, mcmc=25),
])
def test_range_prods(cfg):
    assert _range_test(seed=17, **cfg)


def test_range_prods_4d():
    # reference config D=4, M=6, n=200, MCMC=10 (test/runtests.jl:195)
    assert _range_test(seed=23, D=4, M=6, n=200, mcmc=10)


@pytest.mark.parametrize("cfg", [
    dict(D=2, M=2), dict(D=2, M=6), dict(D=3, M=5, N=300),
])
def test_range_prods_gumbel(cfg):
    """The grid's brackets (kde_tpu's tests/test_gibbs.py:15-50) on keyed
    gumbel products, whose labels come from the counter noise."""
    assert _range_test(seed=29, select="gumbel", **cfg)
