"""The port's density functionals (``kde_tpu/functionals.py``) against the
JAX package, for densities built from NumPy (host branch: NumPy results)
and from tensors (device branch: tensors on the density's device).
float64 results agree at rtol 1e-12; the unscented KL, which contains an
LOOCV fit, at 1e-9; the float32 tiled route at rtol = atol = 2e-4 (the
tolerance of tests/test_pallas_eval.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import kde_tpu  # noqa: E402
from kde_tpu import manifolds as jm  # noqa: E402
import kde_tpu_torch as kt  # noqa: E402
from kde_tpu_torch import config as tconfig  # noqa: E402
from kde_tpu_torch import manifolds as tm  # noqa: E402
from kde_tpu_torch.ops import tiled_eval  # noqa: E402

F64 = torch.float64


def _pair(seed, d=2, n=(120, 90), bw=(0.4, 0.5)):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(d, n[0]))
    b = rng.normal(size=(d, n[1])) * 1.3 + 0.4
    w = rng.uniform(0.2, 1.0, size=n[0])
    return (a, [bw[0]] * d, w), (b, [bw[1]] * d, None)


def _both(args, backing):
    """The same density in kde_tpu and the port, host- or tensor-backed."""
    pts, bw, w = args
    if backing == "host":
        return (kde_tpu.kde(pts, bw, w), kt.kde(pts, bw, w, dtype=F64))
    wj = None if w is None else jnp.asarray(w)
    wt = None if w is None else torch.as_tensor(w)
    return (kde_tpu.kde(jnp.asarray(pts), jnp.asarray(bw), wj),
            kt.kde(torch.as_tensor(pts), torch.as_tensor(np.asarray(bw)),
                   wt))


def _close(got, want, rtol=1e-12):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=1e-14)


@pytest.fixture(params=["host", "tensor"])
def dens(request):
    a, b = _pair(0)
    (jp, tp), (jq, tq) = _both(a, request.param), _both(b, request.param)
    if request.param == "tensor":
        assert tp._host_points is None and jp._host_points is None
    return request.param, jp, tp, jq, tq


def test_log_likelihood_entropy_kld(dens):
    _, jp, tp, jq, tq = dens
    _close(kt.eval_avg_logl(tp, tq), kde_tpu.eval_avg_logl(jp, jq))
    _close(kt.eval_avg_logl(tp, tp), kde_tpu.eval_avg_logl(jp, jp))
    _close(kt.entropy(tp), kde_tpu.entropy(jp))
    _close(kt.kld(tp, tq), kde_tpu.kld(jp, jq))
    _close(kt.minkld(tp, tq), kde_tpu.minkld(jp, jq))
    with pytest.raises(ValueError, match="kld method"):
        kt.kld(tp, tq, "bogus")


def test_kld_unscented(dens):
    backing, jp, tp, jq, tq = dens
    got = kt.kld(tp, tq, "unscented")
    assert isinstance(got, torch.Tensor)
    _close(got, kde_tpu.kld(jp, jq, "unscented"), rtol=1e-9)


def test_summaries(dens):
    backing, jp, tp, jq, tq = dens
    kind = np.ndarray if backing == "host" else torch.Tensor
    for name in ("get_kde_range", "get_kde_range_linspace", "get_kde_max",
                 "get_kde_mean"):
        got = getattr(kt, name)(tp)
        assert isinstance(got, kind), name
        _close(got, getattr(kde_tpu, name)(jp))
    for g, w in zip(kt.get_kde_fit(tp), kde_tpu.get_kde_fit(jp)):
        assert isinstance(g, kind)
        _close(g, w)
    _close(kt.get_kde_range(tp, 0.25), kde_tpu.get_kde_range(jp, 0.25))
    _close(kt.get_kde_range([tp, tq]), kde_tpu.get_kde_range([jp, jq]))


def test_range_of_mixed_list():
    """A list holding a host-backed and a tensor-backed density gives a
    tensor (the JAX package: a device array)."""
    a, b = _pair(1)
    (jp, tp), (jq, tq) = _both(a, "host"), _both(b, "tensor")
    got = kt.get_kde_range([tp, tq])
    assert isinstance(got, torch.Tensor)
    _close(got, kde_tpu.get_kde_range([jp, jq]))


@pytest.mark.parametrize("d", [1, 2])
def test_overlap_integral(dens, d):
    backing = dens[0]
    a, b = _pair(2, d=d, n=(60, 50))
    (jp, tp), (jq, tq) = _both(a, backing), _both(b, backing)
    got = kt.inters_intg_appx_is(tp, tq, n=51)
    assert isinstance(got, float if backing == "host" else torch.Tensor)
    _close(got, kde_tpu.inters_intg_appx_is(jp, jq, n=51))


def test_overlap_rejects_three_dims():
    p = kt.kde(np.zeros((3, 4)), [1.0], dtype=F64)
    with pytest.raises(NotImplementedError, match="dims <= 2"):
        kt.inters_intg_appx_is(p, p)


def test_evaluate_dual_tree(dens):
    _, jp, tp, jq, tq = dens
    _close(kt.evaluate_dual_tree(tp, tq), kde_tpu.evaluate_dual_tree(jp, jq))
    _close(kt.evaluate_dual_tree(tp, tp), kde_tpu.evaluate_dual_tree(jp, jp))
    pos = np.random.default_rng(3).normal(size=(2, 17))
    _close(kt.evaluate_dual_tree(tp, pos),
           kde_tpu.evaluate_dual_tree(jp, jnp.asarray(pos)))


@pytest.mark.parametrize("backing", ["host", "tensor"])
def test_hooked_range_and_max(backing):
    """Circular hooks widen the extent through the wrap."""
    rng = np.random.default_rng(4)
    pts = np.pi - 0.3 + 0.1 * rng.normal(size=(1, 80))
    pts = pts - 2 * np.pi * np.round(pts / (2 * np.pi))
    jh = dict(addop=(jm.circular_add,), diffop=(jm.circular_diff,))
    th = dict(addop=(tm.circular_add,), diffop=(tm.circular_diff,))
    if backing == "host":
        jp, tp = kde_tpu.kde(pts, [0.1], **jh), kt.kde(pts, [0.1], **th,
                                                       dtype=F64)
    else:
        jp = kde_tpu.kde(jnp.asarray(pts), jnp.asarray([0.1]), **jh)
        tp = kt.kde(torch.as_tensor(pts), torch.as_tensor(np.array([0.1])),
                    **th)
    _close(kt.get_kde_range(tp), kde_tpu.get_kde_range(jp))
    _close(kt.get_kde_max(tp), kde_tpu.get_kde_max(jp))


def test_float32_tiled_route(monkeypatch):
    """With both gates at 1 the float32 functionals go through the tiled
    route (on the CPU the kernel's plain twin, forward and LOO)."""
    calls = []
    ref = tiled_eval.tiled_log_eval_ref

    def spy(*a, **k):
        calls.append(bool(k.get("loo", a[4] if len(a) > 4 else False)))
        return ref(*a, **k)
    monkeypatch.setattr(tiled_eval, "tiled_log_eval_ref", spy)
    monkeypatch.setattr(tconfig, "DIRECT_PAIR_LIMIT", 1)
    monkeypatch.setattr(tconfig, "LOOCV_PAIR_LIMIT", 1)
    a, b = _pair(5)
    (jp, _), (jq, _) = _both(a, "host"), _both(b, "host")
    tp, tq = (kt.kde(x[0], x[1], x[2], dtype=torch.float32) for x in (a, b))
    for got, want in ((kt.entropy(tp), kde_tpu.entropy(jp)),
                      (kt.eval_avg_logl(tp, tq),
                       kde_tpu.eval_avg_logl(jp, jq)),
                      (kt.kld(tp, tq), kde_tpu.kld(jp, jq)),
                      (kt.minkld(tp, tq), kde_tpu.minkld(jp, jq))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)
    assert True in calls and False in calls and tiled_eval.LAUNCHES == 0
