"""K1, the tiled mixture evaluator: the port's plain twin against the JAX
package's Pallas kernel (interpret mode) in float32 at rtol = atol = 2e-4
(the tolerance of tests/test_pallas_eval.py; the sums run in another
order), and against the dense JAX evaluators in float64 at rtol 1e-12.
The CUDA kernel itself is checked against the twin on the card
(tests/test_torch_cuda.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from kde_tpu.ops import kernels as jkernels  # noqa: E402
from kde_tpu.ops.pallas_eval import pallas_log_eval  # noqa: E402
from kde_tpu_torch.ops import tiled_eval  # noqa: E402

SHAPES = [(100, 300, 2), (512, 512, 1), (70, 1200, 4)]


def _inputs(m, n, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(m, d))
    mu = rng.normal(size=(n, d))
    var = rng.uniform(0.2, 1.0, size=(n, d))
    w = rng.uniform(0.1, 1.0, size=n)
    return q, mu, var, w / w.sum()


def _t(x, dtype):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("m,n,d", SHAPES)
def test_ref_f32_matches_pallas(m, n, d):
    q, mu, var, w = _inputs(m, n, d)
    want = pallas_log_eval(*(jnp.asarray(x, jnp.float32)
                             for x in (q, mu, var, w)), interpret=True)
    got = tiled_eval.tiled_log_eval(*(_t(x, torch.float32)
                                      for x in (q, mu, var, w)))
    assert got.dtype == torch.float32 and tiled_eval.LAUNCHES == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n,d", [(300, 2), (1, 1)])
def test_ref_f32_loo_matches_pallas(n, d):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(n, d))
    var = np.full((n, d), 0.3)
    w = np.full(n, 1.0 / n)
    want = np.asarray(pallas_log_eval(
        *(jnp.asarray(x, jnp.float32) for x in (pts, pts, var, w)),
        loo=True, interpret=True))
    got = tiled_eval.tiled_log_eval(
        *(_t(x, torch.float32) for x in (pts, pts, var, w)), loo=True).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    if n == 1:
        assert np.isneginf(got).all()     # every component masked
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("m,n,d", SHAPES)
def test_ref_f64_matches_dense(m, n, d):
    q, mu, var, w = _inputs(m, n, d, seed=2)
    want = jkernels.log_eval(*(jnp.asarray(x) for x in (q, mu, var, w)))
    got = tiled_eval.tiled_log_eval_ref(*(_t(x, torch.float64)
                                          for x in (q, mu, var, w)), chunk=37)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_ref_f64_loo_matches_dense():
    rng = np.random.default_rng(3)
    n, d = 257, 3
    pts = rng.normal(size=(n, d))
    var = rng.uniform(0.1, 0.5, size=(n, d))
    w = rng.uniform(0.1, 1.0, size=n)
    w /= w.sum()
    want = jkernels.log_eval_loo(*(jnp.asarray(x) for x in (pts, var, w)))
    tp, tv, tw = (_t(x, torch.float64) for x in (pts, var, w))
    got = (tiled_eval.tiled_log_eval_ref(tp, tp, tv, tw, loo=True, chunk=50)
           - torch.log1p(-tw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_ref_zero_weight_components():
    """Zero-weight components (log w = -inf) add nothing."""
    q, mu, var, w = _inputs(20, 40, 2, seed=4)
    w2 = np.concatenate([w, np.zeros(5)])
    mu2 = np.concatenate([mu, np.zeros((5, 2))])
    var2 = np.concatenate([var, np.ones((5, 2))])
    a = tiled_eval.tiled_log_eval_ref(*(_t(x, torch.float64)
                                        for x in (q, mu, var, w)))
    b = tiled_eval.tiled_log_eval_ref(*(_t(x, torch.float64)
                                        for x in (q, mu2, var2, w2)))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-14)
