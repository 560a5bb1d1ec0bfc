"""LOO entropies and LOOCV bandwidth selection of the port against the JAX
package.  float64 comparisons are held at rtol 1e-12 (entropies) and 1e-10
(selected bandwidths: the same golden-search trajectory over entropies
that agree to ~1e-15)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import kde_tpu  # noqa: E402
from fixtures import load_fixture, load_points  # noqa: E402
from kde_tpu.ops import kernels as jkernels  # noqa: E402
from kde_tpu.ops import loocv as jloocv  # noqa: E402
from kde_tpu_torch import config as tconfig  # noqa: E402
from kde_tpu_torch import kde as tkde  # noqa: E402
from kde_tpu_torch.ops import kernels as tkernels  # noqa: E402
from kde_tpu_torch.ops import loocv as tloocv  # noqa: E402
from kde_tpu_torch.ops import tiled_eval  # noqa: E402

F64 = torch.float64


def _rows(seed=0, d=2, n=150):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(d, n)) * np.array([[1.0], [2.5], [0.3]])[:d]
    w = rng.uniform(0.2, 1.0, size=n)
    return pts, w / w.sum()


@pytest.mark.parametrize("impl", ["dense", "chunk", "tiled"])
def test_batched_loo_entropy_matches_jax(impl):
    pts, w = _rows()
    scale = np.array([0.7, 1.3])
    base = np.array([0.05, 0.4])
    jimpl = "dense" if impl == "dense" else "chunk"
    want = jkernels.batched_loo_entropy(
        jnp.asarray(pts), jnp.asarray(scale), jnp.asarray(base),
        jnp.asarray(w), impl=jimpl, chunk=64)
    got = tkernels.batched_loo_entropy(
        *(torch.as_tensor(x, dtype=F64) for x in (pts, scale, base, w)),
        impl=impl, chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_dense_probe_matches_jax():
    pts, w = _rows(seed=1)
    var = np.array([0.03, 0.6])
    want = jkernels.loo_entropy_given_d2(
        jkernels.loo_pairwise_d2(jnp.asarray(pts)), jnp.asarray(var),
        jnp.asarray(w))
    got = tkernels.loo_entropy_given_d2(
        tkernels.loo_pairwise_d2(torch.as_tensor(pts)),
        torch.as_tensor(var), torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_ksize_bandwidths_match_jax(monkeypatch):
    # pin both packages to their device-dtype searches (not the float64
    # small routes)
    monkeypatch.setattr(kde_tpu.config, "HOST_LOOCV_LIMIT", 0)
    monkeypatch.setattr(tconfig, "HOST_LOOCV_LIMIT", 0)
    pts, w = _rows(seed=2, d=3, n=120)
    want_host = jloocv.ksize_bandwidths(pts.T, w)
    want_dev = np.asarray(jloocv.ksize_bandwidths_device(
        jnp.asarray(pts.T), jnp.asarray(w)))
    got = tloocv.ksize_bandwidths(pts.T, w, dtype=F64)
    got_dev = tloocv.ksize_bandwidths_device(torch.as_tensor(pts.T), w)
    np.testing.assert_allclose(got, want_host, rtol=1e-10)
    np.testing.assert_allclose(got_dev.numpy(), want_dev, rtol=1e-10)


def test_device_fit_arrays_match_jax():
    pts, w = _rows(seed=3, n=90)
    jp, jv, jw = jloocv.device_fit_arrays(jnp.asarray(pts), jnp.asarray(w))
    tp, tv, tw = tloocv.device_fit_arrays(torch.as_tensor(pts), w)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-15)


def test_select_loo_impl_routes(monkeypatch):
    assert tloocv.select_loo_impl(100, torch.float32) == "dense"
    monkeypatch.setattr(tconfig, "LOOCV_PAIR_LIMIT", 1)
    assert tloocv.select_loo_impl(100, torch.float32) == "tiled"
    assert tloocv.select_loo_impl(100, F64) == "chunk"


def test_forced_tiled_route_f32(monkeypatch):
    """With the gate at 1 a float32 fit takes the tiled route, which on the
    CPU is the kernel's plain twin; the bandwidths agree with the float64
    selection within the search tolerance 1e-2."""
    calls = []
    ref = tiled_eval.tiled_log_eval_ref

    def spy(*a, **k):
        calls.append(a[0].shape)
        return ref(*a, **k)
    monkeypatch.setattr(tiled_eval, "tiled_log_eval_ref", spy)
    monkeypatch.setattr(tconfig, "LOOCV_PAIR_LIMIT", 1)
    pts, w = _rows(seed=4, n=200)
    want = tloocv.ksize_bandwidths(pts.T, w, dtype=F64)
    assert not calls                       # float64 takes the chunked path
    got = tloocv.ksize_bandwidths(pts.T, w, dtype=torch.float32)
    assert calls and tiled_eval.LAUNCHES == 0
    np.testing.assert_allclose(got, want, rtol=1e-2)


def test_lcv_1d_golden_fixture():
    """reference test/runtests.jl:104-116 (UnitTest1Dlcv01), tol 1e-4."""
    x = load_points("test1Dlcv100.txt")
    p = tkde(x, dtype=F64)
    fx = load_fixture("test1Dlcv100Result.txt")
    tree = p.tree
    np.testing.assert_allclose(tree.centers.reshape(-1), fx["centers"],
                               atol=1e-4)
    np.testing.assert_allclose(tree.means.reshape(-1), fx["means"], atol=1e-4)
    np.testing.assert_allclose(tree.bandwidth.reshape(-1), fx["bandwidth"],
                               atol=1e-4)
    np.testing.assert_allclose(tree.weights, fx["weights"], atol=1e-6)
    np.testing.assert_array_equal(tree.left, fx["left_child"].astype(int))
    np.testing.assert_array_equal(tree.right, fx["right_child"].astype(int))
    np.testing.assert_array_equal(tree.permutation[100:],
                                  fx["permutation"][100:].astype(int))
