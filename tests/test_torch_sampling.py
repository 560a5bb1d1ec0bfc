"""The port's sampling and resampling (``kde_tpu/ops/sampling.py``).

Keyed draws come from torch generators and differ from the JAX package's
for the same seed, so draws are held to their moments, and the exact
pieces to the JAX package: the index draw on the same uniforms, the
structure of ``sample_at``, the points of a ``discrete`` resample and the
LOOCV refit of an ``lcv`` resample (rtol 1e-10)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import kde_tpu  # noqa: E402
import kde_tpu_torch as kt  # noqa: E402
from kde_tpu_torch import manifolds as tm  # noqa: E402
from kde_tpu_torch.ops.sampling import draw_indices  # noqa: E402

F64 = torch.float64


@pytest.mark.parametrize("n", [1, 7, 300])
def test_index_draw_matches_jax_searchsorted(n):
    """The weight CDF and ``searchsorted(right)`` of
    ``kde_tpu/ops/sampling.py:41-45`` on the same sorted uniforms, with
    uniforms placed exactly on CDF steps and at 0 and 1."""
    rng = np.random.default_rng(n)
    w = rng.uniform(0.0, 1.0, size=n)
    w[rng.integers(0, n)] = 0.0 if n > 1 else 1.0
    w /= w.sum()
    u = np.sort(np.concatenate([rng.uniform(size=500), [0.0, 1.0],
                                np.cumsum(w)[:3] / np.cumsum(w)[-1]]))
    cdf = jnp.cumsum(jnp.asarray(w))
    cdf = cdf / cdf[-1]
    want = jnp.clip(jnp.searchsorted(cdf, jnp.asarray(u), side="right"),
                    0, n - 1)
    got = draw_indices(torch.as_tensor(w), torch.as_tensor(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _density(seed=0, multibw=False, **kw):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(2, 200)) * np.array([[1.0], [0.5]])
    w = rng.uniform(0.2, 1.0, size=200)
    bw = rng.uniform(0.1, 0.3, size=(2, 200)) if multibw else [0.2, 0.1]
    return kt.kde(pts, bw, w, dtype=F64, **kw)


def test_sample_moments():
    """20,000 draws against the mixture's mean and variance (standard
    error of the mean ~0.007; bounds ~6 standard errors)."""
    p = _density()
    pts, ind = kt.sample(p, 20000, key=0)
    assert pts.shape == (2, 20000) and ind.shape == (20000,)
    assert int(ind.min()) >= 0 and int(ind.max()) < p.npts
    w = p.weights.numpy()[:, None]
    mu = (w * p.points.numpy()).sum(0)
    var = (w * (p.points.numpy() ** 2 + p.bw.numpy())).sum(0) - mu ** 2
    x = pts.numpy()
    np.testing.assert_array_less(np.abs(x.mean(1) - mu), 0.04)
    np.testing.assert_array_less(np.abs(x.var(1) / var - 1.0), 0.05)
    again, _ = kt.sample(p, 20000, key=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again.numpy(), x)
    assert kt.rand_kde(p, 5, key=1).shape == (2, 5)


def test_sample_at_residuals():
    p = _density(1, multibw=True)
    ind = np.random.default_rng(2).integers(0, p.npts, size=5000)
    pts, got = kt.sample_at(p, ind, key=3)
    np.testing.assert_array_equal(got.numpy(), ind)
    r = ((pts.T - p.points[got]) / torch.sqrt(p.bw[got])).numpy()
    assert np.isfinite(r).all()
    np.testing.assert_array_less(np.abs(r.mean(0)), 0.06)
    np.testing.assert_array_less(np.abs(r.var(0) - 1.0), 0.06)


@pytest.mark.parametrize("multibw", [False, True])
def test_resample_discrete(multibw):
    circ = dict(addop=(tm.circular_add,), diffop=(tm.circular_diff,),
                get_mu=(tm.circular_mu,), get_lambda=(tm.circular_lambda,))
    p = _density(4, multibw, **circ)
    r = kt.resample(p, 150, "discrete", key=5)
    assert r.npts == 150 and r.dtype == F64 and r.device == p.device
    assert r.diffop[0] is tm.circular_diff and r.multibandwidth == multibw
    src = {tuple(x) for x in p.points.numpy()}
    assert all(tuple(x) in src for x in r.points.numpy())
    # each point keeps its kernel's bandwidth, as the JAX package does
    ind = [int(np.flatnonzero((p.points.numpy() == x).all(1))[0])
           for x in r.points.numpy()]
    want = p.bw.numpy()[ind] if multibw else p.bw.numpy()[:1]
    np.testing.assert_allclose(r.bw.numpy(), np.broadcast_to(want, (150, 2)),
                               rtol=1e-15)


def test_resample_lcv_refits_like_jax(monkeypatch):
    monkeypatch.setattr(kde_tpu.config, "HOST_LOOCV_LIMIT", 0)
    p = _density(6)
    r = kt.resample(p, 120, "lcv", key=7)
    assert r.npts == 120 and r.dtype == F64 and not r.multibandwidth
    want = kde_tpu.kde(r.host_points())
    np.testing.assert_allclose(r.host_bw_std(), want.host_bw_std(),
                               rtol=1e-10)
    assert kt.resample(p).npts == p.npts


def test_resample_rejects_unknown_type():
    with pytest.raises(ValueError, match="ks_type"):
        kt.resample(_density(), 16, "Discrete")
