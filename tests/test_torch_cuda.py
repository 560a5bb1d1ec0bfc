"""Tests that need a CUDA card: the hand-written kernel against its plain
twin, and the port's main path at a small size on the card.  They import
neither JAX nor kde_tpu, so on the GPU machine they run without the JAX
package's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Elsewhere they skip.  The kernel sums in float32 in another order than the
twin, hence rtol = atol = 2e-4 (the tolerance of tests/test_pallas_eval.py);
-inf positions must agree exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want):
    g, r = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isneginf(g), np.isneginf(r))
    fin = np.isfinite(r)
    assert np.isfinite(g[fin]).all()
    np.testing.assert_allclose(g[fin], r[fin], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("m,n,d,loo", [(1000, 777, 3, False),
                                       (512, 512, 1, True),
                                       (300, 2000, 9, False),
                                       (5000, 3000, 2, False),
                                       (1, 1, 1, True)])
def test_kernel_matches_ref(cuda, m, n, d, loo):
    from kde_tpu_torch.ops import tiled_eval
    rng = np.random.default_rng(m + n + d)
    mu = rng.normal(size=(n, d))
    q = mu if loo else rng.normal(size=(m, d))
    var = rng.uniform(0.2, 1.0, size=(n, d))
    w = rng.uniform(0.1, 1.0, size=n)
    w /= w.sum()
    args = [torch.as_tensor(x, dtype=torch.float32, device=cuda)
            for x in (q, mu, var, w)]
    before = tiled_eval.LAUNCHES
    got = tiled_eval.tiled_log_eval(*args, loo=loo)
    torch.cuda.synchronize()
    assert tiled_eval.LAUNCHES == before + 1
    _assert_close(got, tiled_eval.tiled_log_eval_ref(*args, loo=loo))


def test_kernel_rejects_float64(cuda):
    from kde_tpu_torch.ops import tiled_eval
    x = torch.zeros(4, 2, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        tiled_eval.tiled_log_eval(x, x, x + 1, x[:, 0] + 0.25)


def test_small_slice_on_card(cuda, monkeypatch):
    """fit -> product -> refit -> evaluate on the card with the gates low,
    so every stage reaches the kernel; the evaluation agrees with the same
    density evaluated on the CPU in float64."""
    import kde_tpu_torch as kt
    from kde_tpu_torch import config
    from kde_tpu_torch.ops import kernels, tiled_eval
    monkeypatch.setattr(config, "DIRECT_PAIR_LIMIT", 1)
    monkeypatch.setattr(config, "LOOCV_PAIR_LIMIT", 1)
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.normal(size=(2, 300)), dtype=torch.float32,
                        device=cuda)
    b = torch.as_tensor(rng.normal(size=(2, 300)) + 0.5,
                        dtype=torch.float32, device=cuda)
    n0 = tiled_eval.LAUNCHES
    p, q = kt.kde(a), kt.kde(b)
    n1 = tiled_eval.LAUNCHES
    pq = kt.product([p, q], key=0)
    n2 = tiled_eval.LAUNCHES
    queries = rng.normal(size=(2, 500))
    lp = pq.log_eval(queries)
    n3 = tiled_eval.LAUNCHES
    assert n1 > n0 and n2 > n1 and n3 == n2 + 1
    assert pq.points.is_cuda and torch.all(pq.bw > 0)
    ref = kernels.log_eval(torch.as_tensor(queries.T), pq.points.cpu().double(),
                           pq.bw.cpu().double(), pq.weights.cpu().double())
    _assert_close(lp, ref)
