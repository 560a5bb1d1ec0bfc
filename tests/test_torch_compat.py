"""The port's compatibility surface against the JAX package: the export
list, ``nloo_ll``/``ksize``/``golden`` (entropies at rtol 1e-12, LOOCV
bandwidths at 1e-10), the tree accessors, the kernel-type marker and the
debug helpers."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import kde_tpu  # noqa: E402
from kde_tpu.utils import debug as jdebug  # noqa: E402
import kde_tpu_torch as kt  # noqa: E402
from kde_tpu_torch import config as tconfig  # noqa: E402
from kde_tpu_torch.utils import debug as tdebug  # noqa: E402
from kde_tpu_torch.utils import fence  # noqa: E402

F64 = torch.float64


def test_export_surface_covers_jax():
    assert set(kt.__all__) >= set(kde_tpu.__all__)
    for name in kt.__all__:
        assert hasattr(kt, name), name
    assert kt.golden is kt.golden_batched
    assert kt.BallTreeDensity is kt.KDE and kt.MixtureDensity is kt.KDE
    assert kt.BallTree is kt.FlatBallTree


def test_free_functions_and_force_eval_direct():
    p = kt.kde(np.zeros((2, 4)), [1.0, 2.0], dtype=F64)
    assert kt.npts(p) == 4 and kt.ndim(p) == 2 and kt.root(p) == 0
    m = kt.marginal(p, [1])
    assert m.ndim == 1 and float(m.get_bw()[0, 0]) == 2.0
    assert isinstance(p.tree, kt.BallTree) and isinstance(p, kt.MixtureDensity)
    kt.set_force_eval_direct(False)
    assert tconfig.FORCE_EVAL_DIRECT is False
    kt.set_force_eval_direct(True)
    assert tconfig.FORCE_EVAL_DIRECT is True


@pytest.mark.parametrize("backing", ["host", "tensor"])
def test_nloo_ll_and_ksize_match_jax(backing, monkeypatch):
    monkeypatch.setattr(kde_tpu.config, "HOST_LOOCV_LIMIT", 0)
    monkeypatch.setattr(tconfig, "HOST_LOOCV_LIMIT", 0)
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(2, 80)) * np.array([[1.0], [0.3]])
    if backing == "host":
        jp, tp = kde_tpu.kde(pts, [0.5]), kt.kde(pts, [0.5], dtype=F64)
    else:
        jp = kde_tpu.kde(jnp.asarray(pts), jnp.asarray([0.5]))
        tp = kt.kde(torch.as_tensor(pts), torch.as_tensor(np.array([0.5])))
    for alpha in (0.5, 1.0, 2.0):
        np.testing.assert_allclose(kt.nloo_ll(alpha, tp),
                                   kde_tpu.nloo_ll(alpha, jp), rtol=1e-12)
    np.testing.assert_allclose(kt.nloo_ll(1.0, tp), float(kt.entropy(tp)),
                               rtol=1e-12)
    q = kt.ksize(tp)
    assert q.npts == tp.npts and q.dtype == F64 and q.device == tp.device
    assert (q._host_points is None) == (backing == "tensor")
    np.testing.assert_allclose(q.host_bw_std(),
                               kde_tpu.ksize(jp).host_bw_std(), rtol=1e-10)
    np.testing.assert_array_equal(q.host_points(), tp.host_points())
    multi = kt.kde(pts, rng.uniform(0.1, 0.5, size=(2, 80)), dtype=F64)
    with pytest.raises(ValueError, match="uniform bandwidth"):
        kt.nloo_ll(1.0, multi)


def test_golden_matches_jax():
    """A batch of shifted parabolas with the reference bracket shape."""
    c = np.array([0.3, 1.1, 1.7, 0.95])
    ax, bx, cx = np.full(4, 0.1), np.ones(4), np.full(4, 2.5)
    xt, ft = kt.golden(lambda x: (x - torch.as_tensor(c)) ** 2 + 1.0,
                       ax, bx, cx, 1e-6)
    xj, fj = kde_tpu.golden(lambda x: (x - jnp.asarray(c)) ** 2 + 1.0,
                            ax, bx, cx, 1e-6)
    assert isinstance(xt, np.ndarray) and isinstance(ft, np.ndarray)
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=1e-12)
    np.testing.assert_allclose(ft, np.asarray(fj), rtol=1e-12)
    np.testing.assert_allclose(xt, c, atol=1e-5)


def test_bw_bounds_and_kernel_type():
    """The values of tests/test_compat_api.py:85-95."""
    p = kt.kde(np.array([[0.0, 1.0, 2.0]]), [0.5], dtype=F64)
    np.testing.assert_allclose(p.bw_min(), [0.25])
    np.testing.assert_allclose(p.bw_max(2), [0.25])
    q = kt.kde(np.array([[0.0, 1.0, 2.0]]), np.array([[0.1, 0.2, 0.4]]),
               dtype=F64)
    jq = kde_tpu.kde(np.array([[0.0, 1.0, 2.0]]), np.array([[0.1, 0.2, 0.4]]))
    np.testing.assert_allclose(q.bw_min(0), [0.01])
    np.testing.assert_allclose(q.bw_max(0), [0.16])
    for i in range(2 * q.npts):
        np.testing.assert_array_equal(q.bw_min(i), jq.bw_min(i))
        np.testing.assert_array_equal(q.bw_max(i), jq.bw_max(i))
    assert p.kernel_type.name == "Gaussian"
    assert q.kernel_type is p.kernel_type


def test_print_ball_tree_equals_jax(capsys):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(2, 23))
    bw = rng.uniform(0.1, 0.4, size=(2, 23))
    for args in ((pts, [0.3]), (pts, bw)):
        jdebug.print_ball_tree(kde_tpu.kde(*args).tree)
        want = capsys.readouterr().out
        tdebug.print_ball_tree(kt.kde(*args, dtype=F64).tree)
        assert capsys.readouterr().out == want
        assert "num_points=23" in want


def test_print_chain_state(capsys):
    p = kt.kde(np.array([[0.0, 1.0, 2.0]]), [0.5], dtype=F64)
    pts, idx, labels = kt.prod_appx_ms_gibbs(2, [p, p], record_labels=True,
                                             key=0)
    tdebug.print_chain_state(pts, idx, labels, sample=1)
    out = capsys.readouterr().out
    assert "chain 1: x=" in out and out.count("level path") == 2
    jdebug.print_chain_state(pts.numpy(), idx.numpy(), labels.numpy(), 1)
    assert capsys.readouterr().out == out


def test_fence_and_profile_trace(tmp_path):
    v = fence(torch.ones((3, 3)), (torch.zeros(4), [torch.arange(5)]),
              {"a": torch.full((2,), 0.5), "b": [torch.ones(1)]})
    assert v == 9.0 + 0.0 + 10.0 + 1.0 + 1.0
    assert fence() == 0.0
    with tdebug.profile_trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert prof.key_averages() is not None
    assert (tmp_path / "trace.json").is_file()
