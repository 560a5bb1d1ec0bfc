"""The port's main path as a whole against the JAX package: LOOCV fits of
two 2-D densities, their Gibbs product (replay streams), the LOOCV refit of
the samples, and evaluation of the result.  float64 stages agree at rtol
1e-9; the float32 tiled route agrees at rtol = atol = 2e-4 (the tolerance
of tests/test_pallas_eval.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import kde_tpu  # noqa: E402
from fixtures import gibbs_streams  # noqa: E402
from kde_tpu.ops import kernels as jkernels  # noqa: E402
import kde_tpu_torch as kt  # noqa: E402
from kde_tpu_torch import config as tconfig  # noqa: E402
from kde_tpu_torch.ops import kernels as tkernels  # noqa: E402
from kde_tpu_torch.ops import tiled_eval  # noqa: E402

F64 = torch.float64
N_ITER = 5


@pytest.fixture(scope="module")
def slice_f64():
    """Both packages through fit -> product -> refit -> evaluate."""
    # pin both packages to their device-dtype routes (not the float64
    # small routes of their host_small modules)
    gates = ("HOST_LOOCV_LIMIT", "HOST_EVAL_LIMIT")
    saved = [(cfg, g, getattr(cfg, g)) for cfg in (kde_tpu.config, tconfig)
             for g in gates]
    for cfg, g, _ in saved:
        setattr(cfg, g, 0)
    try:
        rng = np.random.default_rng(20)
        a = rng.normal(size=(2, 150))
        b = rng.normal(size=(2, 120)) + 0.5
        queries = rng.normal(size=(2, 64)) * 1.5
        jp, jq = kde_tpu.kde(a), kde_tpu.kde(b)
        tp, tq = kt.kde(a, dtype=F64), kt.kde(b, dtype=F64)
        n_out = int(round((150 + 120) / 2))
        ru, rn, _ = gibbs_streams(rng, 2, 2, n_out, N_ITER, 150)
        pts_j = kde_tpu.prod_appx_ms_gibbs(n_out, [jp, jq], n_iter=N_ITER,
                                           rand_u=ru, rand_n=rn)[0]
        copies = [kt.kde_from_numpy(np.asarray(p.points), np.asarray(p.bw),
                                    np.asarray(p.weights), p.multibandwidth,
                                    dtype=F64) for p in (jp, jq)]
        pts_t = kt.prod_appx_ms_gibbs(n_out, copies, n_iter=N_ITER,
                                      rand_u=ru, rand_n=rn)[0]
        jpq, tpq = kde_tpu.kde(pts_j), kt.kde(pts_t)
        yield dict(jp=jp, jq=jq, tp=tp, tq=tq, pts_j=np.asarray(pts_j),
                   pts_t=pts_t.numpy(), jpq=jpq, tpq=tpq, queries=queries,
                   lp_j=np.asarray(jpq.log_eval(jnp.asarray(queries))),
                   lp_t=tpq.log_eval(queries).numpy())
    finally:
        for cfg, g, value in saved:
            setattr(cfg, g, value)


def test_fits_match(slice_f64):
    s = slice_f64
    for j, t in ((s["jp"], s["tp"]), (s["jq"], s["tq"])):
        np.testing.assert_allclose(t.host_bw_std(), j.host_bw_std(),
                                   rtol=1e-9)
        np.testing.assert_array_equal(t.host_points(), j.host_points())


def test_product_points_match(slice_f64):
    s = slice_f64
    assert s["pts_t"].shape == (2, 135)
    np.testing.assert_allclose(s["pts_t"], s["pts_j"], rtol=1e-9,
                               atol=1e-12)


def test_refit_matches(slice_f64):
    s = slice_f64
    np.testing.assert_allclose(s["tpq"].bw.numpy(), np.asarray(s["jpq"].bw),
                               rtol=1e-9)
    np.testing.assert_allclose(s["tpq"].weights.numpy(),
                               np.asarray(s["jpq"].weights), rtol=1e-15)


def test_log_eval_matches(slice_f64):
    s = slice_f64
    assert np.all(np.isfinite(s["lp_t"]))
    np.testing.assert_allclose(s["lp_t"], s["lp_j"], rtol=1e-9)


def test_tiled_route_f32(slice_f64, monkeypatch):
    """With both gates at 1 (and the small route's at 0), float32
    evaluation and LOO self-evaluation of the refit density take the tiled
    route: on the CPU, the kernel's plain twin."""
    s = slice_f64
    calls = []
    ref = tiled_eval.tiled_log_eval_ref

    def spy(*a, **k):
        calls.append(bool(k.get("loo", a[4] if len(a) > 4 else False)))
        return ref(*a, **k)
    monkeypatch.setattr(tiled_eval, "tiled_log_eval_ref", spy)
    monkeypatch.setattr(tconfig, "DIRECT_PAIR_LIMIT", 1)
    monkeypatch.setattr(tconfig, "LOOCV_PAIR_LIMIT", 1)
    monkeypatch.setattr(tconfig, "HOST_EVAL_LIMIT", 0)
    jpq = s["jpq"]
    arrays = [np.asarray(x) for x in (jpq.points, jpq.bw, jpq.weights)]
    t32 = kt.kde_from_numpy(*arrays, False, dtype=torch.float32)
    lp = t32.log_eval(s["queries"])
    loo = tkernels.log_eval_loo(t32.points, t32.bw, t32.weights)
    assert calls == [False, True] and tiled_eval.LAUNCHES == 0
    j32 = [jnp.asarray(x, jnp.float32) for x in arrays]
    want = jkernels.log_eval(jnp.asarray(s["queries"].T, jnp.float32), *j32)
    want_loo = jkernels.log_eval_loo(*j32)
    np.testing.assert_allclose(lp.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(loo.numpy(), np.asarray(want_loo), rtol=2e-4,
                               atol=2e-4)
    # the refit's LOO entropy probe takes the same route
    calls.clear()
    fit = kt.kde(torch.as_tensor(s["pts_t"], dtype=torch.float32))
    assert calls and all(calls)
    np.testing.assert_allclose(fit.bw.numpy(), s["tpq"].bw.numpy(),
                               rtol=1e-2)
