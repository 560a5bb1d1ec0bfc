"""Manifold hooks in the port (``kde_tpu/manifolds.py`` and the hooked
paths of the Gibbs engine and evaluation) against the JAX package.

Replay mode is trace-exact in float64 against
``kde_tpu.prod_appx_ms_gibbs`` with the same hooks: labels equal, points at
rtol 1e-9 / atol 1e-12.  Hooked evaluation matches at rtol 1e-12.  Keyed
products are held to where their mass lands (tests/test_manifolds.py)."""
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import kde_tpu  # noqa: E402
from fixtures import gibbs_streams  # noqa: E402
from kde_tpu import manifolds as jm  # noqa: E402
import kde_tpu_torch as kt  # noqa: E402
from kde_tpu_torch import config as tconfig  # noqa: E402
from kde_tpu_torch import manifolds as tm  # noqa: E402
from kde_tpu_torch.ops import gibbs as tgibbs  # noqa: E402
from kde_tpu_torch.ops import tiled_eval  # noqa: E402

F64 = torch.float64


def _hooks(m, kinds):
    """The hook quadruple of module ``m`` for per-dim ``kinds`` (``e``
    Euclidean, ``c`` circular)."""
    pick = lambda e, c: tuple(e if k == "e" else c for k in kinds)
    return dict(addop=pick(m.euclid_add, m.circular_add),
                diffop=pick(m.euclid_diff, m.circular_diff),
                get_mu=pick(m.euclid_mu, m.circular_mu),
                get_lambda=pick(m.euclid_lambda, m.circular_lambda))


def _wrap(a):
    return a - 2 * np.pi * np.round(a / (2 * np.pi))


def _port(jk, **hooks):
    return kt.KDE(np.asarray(jk.points), np.asarray(jk.bw),
                  np.asarray(jk.weights), jk.multibandwidth, **hooks,
                  dtype=F64)


def _circ_points(rng, n=64):
    return (_wrap(np.pi - 0.2 + 0.05 * rng.normal(size=(1, n))),
            _wrap(-np.pi + 0.2 + 0.05 * rng.normal(size=(1, n))))


def _se2_points(rng, x, y, theta, n=60):
    return np.vstack([x + 0.15 * rng.normal(size=n),
                      y + 0.15 * rng.normal(size=n),
                      _wrap(theta + 0.05 * rng.normal(size=n))])


def test_circular_ops_match_jax():
    """Elementwise ops and the [B, C, dn] reductions over the last axis,
    with ties in lambda (both packages anchor at the first maximum) and
    values exactly on the rounding boundary (half to even)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-7, 7, size=(2, 5, 3))
    b = rng.uniform(-7, 7, size=(2, 5, 3))
    a[0, 0, 0], b[0, 0, 0] = 3 * np.pi, 0.0
    lam = rng.choice([0.0, 1.0, 2.5], size=(2, 5, 3))
    scale = 1.0 / np.maximum(lam.sum(-1), 1.0)
    T = torch.as_tensor
    for tf, jf in ((tm.circular_diff, jm.circular_diff),
                   (tm.circular_add, jm.circular_add)):
        np.testing.assert_allclose(tf(T(a), T(b)).numpy(),
                                   np.asarray(jf(jnp.asarray(a),
                                                 jnp.asarray(b))),
                                   rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(
        tm.circular_mu(T(a), T(lam), T(scale)).numpy(),
        np.asarray(jm.circular_mu(jnp.asarray(a), jnp.asarray(lam),
                                  jnp.asarray(scale))),
        rtol=1e-15, atol=1e-15)
    np.testing.assert_array_equal(
        tm.circular_lambda(T(lam)).numpy(),
        np.asarray(jm.circular_lambda(jnp.asarray(lam))))


def _replay_both(jdens, tdens, n_out, n_iter, jhooks, thooks, seed):
    rng = np.random.default_rng(seed)
    ns = tuple(p.npts for p in jdens)
    ru, rn, _ = gibbs_streams(rng, len(jdens), jdens[0].ndim, n_out, n_iter,
                              max(ns + (n_out,)))
    pj, ij, lj = kde_tpu.prod_appx_ms_gibbs(
        n_out, jdens, n_iter=n_iter, rand_u=ru, rand_n=rn,
        record_labels=True, **jhooks)
    pt, it, lt = kt.prod_appx_ms_gibbs(
        n_out, tdens, n_iter=n_iter, rand_u=ru, rand_n=rn,
        record_labels=True, **thooks)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-9,
                               atol=1e-12)
    return pt.numpy()


def test_replay_circular_pair_trace_exact():
    """The circular pair of tests/test_manifolds.py:67-70 (hooks passed
    explicitly, only ``diffop`` attached)."""
    a, b = _circ_points(np.random.default_rng(0))
    jdens = [kde_tpu.kde(x, [0.1], diffop=(jm.circular_diff,)) for x in (a, b)]
    tdens = [_port(p, diffop=(tm.circular_diff,)) for p in jdens]
    pts = _replay_both(jdens, tdens, 64, 5, _hooks(jm, "c"), _hooks(tm, "c"),
                       1)
    assert np.median(np.abs(_wrap(pts[0] - np.pi))) < 0.5


def test_replay_se2_trace_exact():
    """The SE(2) beliefs of examples/se2_fusion.py at n = 60: Euclidean
    x, y and a circular heading in one quadruple."""
    rng = np.random.default_rng(2)
    jh, th = _hooks(jm, "eec"), _hooks(tm, "eec")
    jdens = [kde_tpu.kde(_se2_points(rng, *c), [0.08, 0.08, 0.05], **jh)
             for c in ((2.0, 1.0, np.pi - 0.15), (2.3, 0.8, -np.pi + 0.15))]
    tdens = [_port(p, **th) for p in jdens]
    pts = _replay_both(jdens, tdens, 32, 3, jh, th, 3)
    assert np.mean(np.abs(pts[2]) > np.pi / 2) > 0.9


def test_set_axis_circular_replay_trace_exact():
    """B = 2 circular sets through the port's batched chain, each against
    ``kde_tpu.prod_appx_ms_gibbs`` with its own streams."""
    rng = np.random.default_rng(4)
    n_out, n_iter, b = 16, 2, 2
    jsets = [[kde_tpu.kde(x + 0.3 * i, [0.1]) for x in _circ_points(rng, 32)]
             for i in range(b)]
    plans = tgibbs._stack_plans([
        tgibbs._get_plan([_port(p) for p in js], n_out, F64,
                         torch.device("cpu")) for js in jsets])
    bu, bn = tgibbs._stream_sizes(2, 1, plans.n_levels, n_iter)
    streams = [gibbs_streams(rng, 2, 1, n_out, n_iter, 32) for _ in range(b)]
    u = torch.as_tensor(np.stack([s[0][:n_out * bu].reshape(n_out, bu)
                                  for s in streams]))
    nrm = torch.as_tensor(np.stack([s[1][:n_out * bn].reshape(n_out, bn)
                                    for s in streams]))
    hooks = tgibbs.normalize_hooks(*_hooks(tm, "c").values(), 1)
    pts, idx, labels = tgibbs._gibbs_all_chains(
        u, nrm, plans, torch.ones((b, 2, 1), dtype=torch.bool), n_iter,
        True, hooks=hooks)
    for i in range(b):
        pj, ij, lj = kde_tpu.prod_appx_ms_gibbs(
            n_out, jsets[i], n_iter=n_iter, rand_u=streams[i][0],
            rand_n=streams[i][1], record_labels=True, **_hooks(jm, "c"))
        np.testing.assert_array_equal(idx[i].numpy().T, np.asarray(ij))
        np.testing.assert_array_equal(labels[i].numpy().transpose(0, 2, 1),
                                      np.asarray(lj))
        np.testing.assert_allclose(pts[i].numpy().T, np.asarray(pj),
                                   rtol=1e-9, atol=1e-12)


def test_euclidean_hooks_match_default():
    """Explicit Euclidean hooks draw exactly the hook-free product."""
    rng = np.random.default_rng(5)
    dens = [kt.kde(rng.normal(size=(1, 16)), [0.4], dtype=F64)
            for _ in range(2)]
    ru, rn, _ = gibbs_streams(rng, 2, 1, 8, 3, 16)
    p1, i1 = kt.prod_appx_ms_gibbs(8, dens, n_iter=3, rand_u=ru, rand_n=rn)
    p2, i2 = kt.prod_appx_ms_gibbs(8, dens, n_iter=3, rand_u=ru, rand_n=rn,
                                   **_hooks(tm, "e"))
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_array_equal(p1.numpy(), p2.numpy())


@pytest.mark.parametrize("kinds", ["c", "ec"])
def test_hooked_evaluation_matches_jax(kinds):
    rng = np.random.default_rng(6)
    d = len(kinds)
    pts = _wrap(rng.normal(size=(d, 80)) * 2.0)
    jp = kde_tpu.kde(pts, [0.3] * d, **_hooks(jm, kinds))
    tp = _port(jp, **_hooks(tm, kinds))
    q = _wrap(rng.normal(size=(d, 50)) * 3.0)
    np.testing.assert_allclose(tp.log_eval(q).numpy(),
                               np.asarray(jp.log_eval(jnp.asarray(q))),
                               rtol=1e-12)
    np.testing.assert_allclose(tp.evaluate(None, lv_flag=True).numpy(),
                               np.asarray(jp.evaluate(None, lv_flag=True)),
                               rtol=1e-12)
    # wrapped differences: a query a full turn away evaluates the same
    np.testing.assert_allclose(tp.log_eval(q + 2 * np.pi * (kinds == "c"))
                               .numpy(), tp.log_eval(q).numpy(), rtol=1e-9)
    # the chunked hooked path agrees with the dense one
    np.testing.assert_allclose(tp.log_eval(q, chunk=7).numpy(),
                               tp.log_eval(q).numpy(), rtol=1e-12)


def test_hooked_float32_never_takes_the_tiled_route(monkeypatch):
    """With DIRECT_PAIR_LIMIT = 1 a hooked float32 density evaluates on
    the chunked diffop path: no kernel launch and no twin call; the same
    density without hooks goes to the twin once."""
    calls = []
    ref = tiled_eval.tiled_log_eval_ref

    def spy(*a, **k):
        calls.append(1)
        return ref(*a, **k)
    monkeypatch.setattr(tiled_eval, "tiled_log_eval_ref", spy)
    monkeypatch.setattr(tconfig, "DIRECT_PAIR_LIMIT", 1)
    rng = np.random.default_rng(7)
    a, _ = _circ_points(rng, 100)
    q = _wrap(rng.normal(size=(1, 40)) * 3.0)
    hooked = kt.kde(a, [0.1], **_hooks(tm, "c"), dtype=torch.float32)
    lp = hooked.log_eval(q)
    hooked.evaluate(None, lv_flag=True)
    assert calls == [] and tiled_eval.LAUNCHES == 0
    want = kde_tpu.kde(a, [0.1], **_hooks(jm, "c")).log_eval(jnp.asarray(q))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    kt.kde(a, [0.1], dtype=torch.float32).log_eval(q)
    assert calls == [1] and tiled_eval.LAUNCHES == 0


def _circ_pair(rng):
    a, b = _circ_points(rng)
    return (kt.kde(a, [0.1], **_hooks(tm, "c"), dtype=F64),
            kt.kde(b, [0.1], **_hooks(tm, "c"), dtype=F64))


def _assert_near_pi(pts):
    pts = pts.numpy()[0]
    assert np.median(np.abs(_wrap(pts - np.pi))) < 0.5
    assert np.mean(np.abs(pts) < 1.0) < 0.2


def test_keyed_circular_products_land_near_pi():
    """`*`, ProductSampler and explicit hooks put the mass near pi, where
    a Euclidean product would put it near 0 (the thresholds of
    tests/test_manifolds.py:81-83)."""
    rng = np.random.default_rng(0)
    pa, pb = _circ_pair(rng)
    pq = pa * pb
    _assert_near_pi(pq.get_points())
    _assert_near_pi(kt.ProductSampler([pa, pb], n_out=64).sample(0)[0])
    _assert_near_pi(kt.prod_appx_ms_gibbs(64, [pa, pb], n_iter=5, key=0,
                                          **_hooks(tm, "c"))[0])
    pts, _ = kt.BatchedProductSampler([[pa, pb], [pa, pb]],
                                      n_out=64).sample(1)
    for i in range(2):
        _assert_near_pi(pts[i])


def test_se2_keyed_product():
    rng = np.random.default_rng(11)
    th = _hooks(tm, "ec")

    def belief(x, t, n=150):
        pts = np.vstack([x + 0.1 * rng.normal(size=n),
                         _wrap(t + 0.05 * rng.normal(size=n))])
        return kt.kde(pts, [0.08, 0.05], **th, dtype=F64)
    fused = belief(2.0, np.pi - 0.15) * belief(2.3, -np.pi + 0.15)
    pts = fused.get_points().numpy()
    assert abs(pts[0].mean() - 2.15) < 0.15
    assert np.mean(np.abs(pts[1]) > np.pi / 2) > 0.9
    assert fused.get_mu[1] is tm.circular_mu
    assert fused.get_mu[0] is tm.euclid_mu


def _assert_circular(k):
    assert k.addop[0] is tm.circular_add
    assert k.diffop[0] is tm.circular_diff
    assert k.get_mu[0] is tm.circular_mu
    assert k.get_lambda[0] is tm.circular_lambda


def test_hooks_are_carried():
    rng = np.random.default_rng(9)
    pa, pb = _circ_pair(rng)
    outs = [pa * pb, kt.ksize(pa), kt.resample(pa, 32, "lcv", key=3),
            kt.resample(pa, 32, "discrete", key=3),
            kt.product([pa], add_entropy=False)]
    outs += kt.product_batched([[pa, pb], [pb, pa]], key=0)
    se2 = kt.kde(_se2_points(rng, 0, 0, 0), [0.1], **_hooks(tm, "eec"),
                 dtype=F64)
    m = se2.marginal([2])
    assert m.ndim == 1 and se2.marginal([0]).get_mu[0] is tm.euclid_mu
    for k in outs + [m]:
        _assert_circular(k)


def _value_error_cases():
    def mixed(rng):
        pa, _ = _circ_pair(rng)
        return pa, kt.kde(rng.normal(size=(1, 64)), [0.3], dtype=F64)

    def partial(rng):
        mk = lambda: kt.kde(rng.normal(size=(1, 64)) * 0.2, [0.1],
                            addop=(tm.circular_add,),
                            diffop=(tm.circular_diff,), dtype=F64)
        return mk(), mk()

    def batched_sets(rng):
        pa, pb = _circ_pair(rng)
        pe = [kt.kde(rng.normal(size=(1, 64)), [0.3], dtype=F64)
              for _ in range(2)]
        kt.BatchedProductSampler([[pa, pb], pe], n_out=32)

    return {
        "mul_mixed": ("manifold hooks", lambda r: mixed(r)[0] * mixed(r)[1]),
        "sampler_mixed": ("manifold hooks",
                          lambda r: kt.ProductSampler(list(mixed(r)), 32)),
        "batched_sets": ("identical manifold hooks", batched_sets),
        "mul_partial": ("quadruple", lambda r: partial(r)[0] * partial(r)[1]),
        "sampler_partial": ("quadruple",
                            lambda r: kt.ProductSampler(list(partial(r)), 32)),
        "resample_ks_type": ("ks_type", lambda r: kt.resample(
            kt.kde(r.normal(size=(1, 32)), [0.3], dtype=F64), 16,
            "Discrete")),
        "op_tuple_length": ("entries", lambda r: kt.kde(
            r.normal(size=(3, 8)), [0.3],
            diffop=(tm.circular_diff, tm.circular_diff))),
    }


@pytest.mark.parametrize("case", sorted(_value_error_cases()))
def test_value_errors(case):
    match, fn = _value_error_cases()[case]
    with pytest.raises(ValueError, match=match):
        fn(np.random.default_rng(1))


def test_hooked_serialization_warns(tmp_path):
    pa, _ = _circ_pair(np.random.default_rng(6))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        kt.to_string(pa)
        kt.save_kde(str(tmp_path / "p.npz"), pa)
    assert sum("manifold hooks" in str(w.message) for w in rec) == 2
    assert not math.isnan(float(kt.entropy(pa)))
