"""The port's float64 small routes (``kde_tpu_torch/ops/host_small.py``)
against ``kde_tpu/ops/host_small.py``, on the CPU, where each wrapper runs
its kernel's plain twin.

Selections agree to rtol 1e-9 (the tolerance of tests/test_host_small.py:
the searches take the same bracket steps, their probes differ only in exp/log
ulps and summation order); ``log p`` to atol 1e-10; the draw on the same
uniforms and normals to 1e-12.  With default gates the port's ``kde``,
evaluation and LOO evaluation of README cfg 1 give ``kde_tpu``'s bandwidths
to rtol 1e-9 and its float64 values to rtol 1e-12.  "Default" is each
package's own: float32 densities (``jax_enable_x64`` off, as outside these
tests)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import kde_tpu  # noqa: E402
from kde_tpu.ops import host_small as jhs  # noqa: E402
from kde_tpu.ops import loocv as jloocv  # noqa: E402
import kde_tpu_torch as kt  # noqa: E402
from kde_tpu_torch import config as tconfig  # noqa: E402
from kde_tpu_torch import manifolds as tm  # noqa: E402
from kde_tpu_torch.ops import host_small as ths  # noqa: E402

F64 = torch.float64
GATES = ("HOST_LOOCV_LIMIT", "HOST_EVAL_LIMIT", "HOST_SAMPLE_LIMIT")


def _cfg1(seed):
    """README cfg 1 (bench.py:220): 50 + 50 bimodal points and a 200-point
    grid over their range."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=50), 10.0 + 2.0 * rng.normal(size=50)])
    return x, np.linspace(x.min(), x.max(), 200)


def _zero_weight_case():
    """tests/test_host_small.py:143-162: every point with a dead twin
    closer than any live neighbour, and a far outlier."""
    rng = np.random.default_rng(13)
    n = 96
    x = np.concatenate([rng.normal(size=n - 1) * 0.01, [500.0]])
    pts = np.concatenate([x, x + 1e-6])[:, None]
    return pts, np.concatenate([np.full(n, 1.0 / n), np.zeros(n)])


def _golden_case(name):
    rng = np.random.default_rng(11)
    if name == "cfg1_d1":
        pts = _cfg1(0)[0][:, None]
    elif name == "d2":
        pts = rng.normal(size=(120, 2)) * [1.0, 2.5]
    elif name == "zero_weights":
        return _zero_weight_case()
    elif name == "gate_edge_d1":
        pts = rng.normal(size=(255, 1))
    else:                                       # "n1", "n2"
        pts = rng.normal(size=(int(name[1:]), 1))
    n = len(pts)
    w = rng.uniform(0.5, 1.5, size=n) if name == "d2" else np.full(n, 1.0 / n)
    return pts, w / w.sum()


@pytest.mark.parametrize("name", ["cfg1_d1", "d2", "zero_weights",
                                  "gate_edge_d1", "n1", "n2"])
def test_ksize_small_ref_matches_ksize_host_np(name):
    pts, w = _golden_case(name)
    lo, hi = jloocv._internal_slices(len(pts))
    bracket = jhs.bracket_rows_np(np.ascontiguousarray(pts.T), lo, hi)
    want = jhs.ksize_host_np(pts, w, *bracket, 1e-2)
    rows = torch.as_tensor(np.ascontiguousarray(pts.T))
    got = ths.ksize_small_ref(rows, torch.as_tensor(w), 1e-2)
    assert got.dtype == F64 and got.shape == (pts.shape[1],)
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9)
    # the wrapper on CPU tensors is the twin, and launches nothing
    launches = dict(ths.LAUNCHES)
    np.testing.assert_array_equal(
        ths.ksize_small(rows, torch.as_tensor(w), 1e-2).numpy(), got.numpy())
    assert ths.LAUNCHES == launches


def _eval_case(name):
    rng = np.random.default_rng(3)
    if name == "cfg1":
        x, grid = _cfg1(1)
        mu, q = x[:, None], grid[:, None]
        var = np.full_like(mu, 0.6 ** 2)
    elif name == "widest":                      # 200 x 300 x 4 = 2^18 - ...
        mu, q = rng.normal(size=(300, 4)), 1.5 * rng.normal(size=(200, 4))
        var = rng.uniform(0.05, 0.5, size=(300, 4))
    elif name == "exp_wrap":                    # test_host_small.py:207-234
        mu = (np.arange(9) * 1e-6)[:, None]
        var = np.full((9, 1), 0.5)
        q = np.sqrt(np.concatenate([np.linspace(705.0, 715.0, 401),
                                    np.linspace(2125.0, 2135.0, 401)]))[:, None]
    else:                                       # "zero_weights"
        mu, q = rng.normal(size=(50, 2)), rng.normal(size=(40, 2))
        var = rng.uniform(0.1, 0.4, size=(50, 2))
    w = rng.uniform(0.5, 1.5, size=len(mu))
    if name == "zero_weights":
        w[::3] = 0.0
    if name == "exp_wrap":
        w = np.ones(len(mu))
    return q, mu, var, w / w.sum()


@pytest.mark.parametrize("name", ["cfg1", "widest", "exp_wrap",
                                  "zero_weights"])
def test_log_eval_small_matches_log_eval_np(name):
    q, mu, var, w = _eval_case(name)
    want = jhs.log_eval_np(q, mu, var, w)
    got = ths.log_eval_small(*(torch.as_tensor(np.ascontiguousarray(a))
                               for a in (q, mu, var, w)))
    assert got.dtype == F64 and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("n,zero", [(100, False), (255, False), (60, True),
                                    (1, False), (2, False)])
def test_log_eval_loo_small_matches_log_eval_loo_np(n, zero):
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(n, 2))
    var = rng.uniform(0.05, 0.3, size=(n, 2))
    w = rng.uniform(0.5, 1.5, size=n)
    if zero:
        w[::4] = 0.0
    w /= w.sum()
    with np.errstate(invalid="ignore"):         # N = 1: -inf + inf
        want = jhs.log_eval_loo_np(pts, var, w)
    got = ths.log_eval_loo_small(*(torch.as_tensor(a) for a in (pts, var, w)))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("multibw", [False, True])
def test_draw_small_matches_sample_np(multibw):
    """The same sorted uniforms and normals (a NumPy generator's, drawn in
    sample_np's order) through both draws."""
    rng = np.random.default_rng(5)
    n, m, d = 80, 300, 2
    pts = rng.normal(size=(n, d))
    var = (rng.uniform(0.01, 0.2, size=(n, d)) if multibw
           else np.full((n, d), 0.05))
    w = rng.uniform(0.0, 1.0, size=n)
    w[3] = 0.0
    w /= w.sum()
    want_pts, want_ind = jhs.sample_np(pts, var, w, m,
                                       np.random.default_rng(9))
    g = np.random.default_rng(9)
    u = np.sort(g.uniform(size=m))
    noise = g.standard_normal(size=(m, d))
    got_pts, got_ind = ths.draw_small(
        *(torch.as_tensor(a) for a in (pts, var, w, u, noise)))
    np.testing.assert_array_equal(got_ind.numpy(), want_ind)
    np.testing.assert_allclose(got_pts.numpy(), want_pts, rtol=1e-12,
                               atol=1e-12)


def test_sample_small_draws_float64_in_order():
    """Sorted uniforms first, then normals, from the one generator."""
    p = kt.kde(np.random.default_rng(2).normal(size=(2, 50)), [0.3])
    pts, var, w = p._small_arrays()
    got, ind = ths.sample_small(pts, var, w, 40, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    u = torch.rand(40, generator=g, dtype=F64).sort().values
    noise = torch.randn((40, 2), generator=g, dtype=F64)
    want, want_ind = ths.draw_small(pts, var, w, u, noise)
    assert got.dtype == F64 and got.shape == (2, 40)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(ind, want_ind, rtol=0, atol=0)


def test_readme_cfg1_defaults_match_kde_tpu():
    """Default settings on both sides: the float64 small routes give
    kde_tpu's bandwidths over seeds 0-39 and its float64 p(grid) and LOO
    values (the float32 search of the parent differed on 3 of 40 seeds)."""
    for seed in range(40):
        x, grid = _cfg1(seed)
        with jax.enable_x64(False):
            pj = kde_tpu.kde(x[None, :])
        pt = kt.kde(x[None, :])
        np.testing.assert_allclose(pt.host_bw_std(), pj.host_bw_std(),
                                   rtol=1e-9, err_msg=f"seed {seed}")
        v = pt(grid)
        assert v.dtype == F64 and pt.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), pj(grid), rtol=1e-12,
                                   err_msg=f"seed {seed}")
        lv = pt.evaluate(None, lv_flag=True)
        assert lv.dtype == F64
        np.testing.assert_allclose(lv.numpy(), pj.evaluate(None, lv_flag=True),
                                   rtol=1e-12, err_msg=f"seed {seed}")


def test_two_dim_fit_defaults_match_kde_tpu():
    """N = 120, d = 2 (tests/test_host_small.py:20-33), default settings."""
    rng = np.random.default_rng(11)
    pts = (rng.normal(size=(120, 2)) * [1.0, 2.5]).T
    with jax.enable_x64(False):
        pj = kde_tpu.kde(pts)
    pt = kt.kde(pts)
    np.testing.assert_allclose(pt.host_bw_std(), pj.host_bw_std(), rtol=1e-9)
    q = rng.normal(size=(2, 64))
    np.testing.assert_allclose(pt(q).numpy(), pj(q), rtol=1e-12)


def test_resample_small_routes_like_kde_tpu():
    """resample under the gate: float64 draws, a NumPy-built result in p's
    dtype whose lcv bandwidth is kde_tpu's selection on the same points,
    and whose own evaluations take the small route again."""
    x, grid = _cfg1(3)
    p = kt.kde(x[None, :])
    pts, _ = kt.sample(p, 75, key=3)            # resample's own draw
    assert pts.dtype == F64
    with jax.enable_x64(False):
        want = kde_tpu.kde(pts.numpy())
    r = kt.resample(p, 75, "lcv", key=3)
    assert r._host_points is not None and r.dtype == torch.float32
    np.testing.assert_array_equal(r.host_points(), want.host_points())
    np.testing.assert_allclose(r.host_bw_std(), want.host_bw_std(),
                               rtol=1e-9)
    assert r(grid).dtype == F64
    d = kt.resample(p, 50, "discrete", key=4)
    assert d._host_points is not None and d.dtype == torch.float32
    assert set(d.host_points()[0]) <= set(p.host_points()[0])
    np.testing.assert_allclose(d.host_bw_std(), p.host_bw_std()[:, :50],
                               rtol=1e-7)


# ---- the gates -------------------------------------------------------------

@pytest.fixture
def spies(monkeypatch):
    """Calls of each package's small routes, by name."""
    calls = []

    def spy(mod, name, tag):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls.append(tag)
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    for mod, tag in ((jhs, "jax"), (ths, "torch")):
        spy(mod, "ksize_host_np" if mod is jhs else "ksize_small", tag)
    return calls


@pytest.mark.parametrize("n,small", [(256, True), (257, False)])
def test_loocv_gate(n, small, spies):
    """N*N*d at the gate (256^2) takes both packages' small routes; one more
    point takes neither."""
    x = np.random.default_rng(n).normal(size=(1, n))
    with jax.enable_x64(False):
        pj = kde_tpu.kde(x)
    pt = kt.kde(x)
    assert spies == (["jax", "torch"] if small else [])
    np.testing.assert_allclose(pt.host_bw_std(), pj.host_bw_std(),
                               rtol=1e-9 if small else 2e-2)


@pytest.mark.parametrize("m,small", [(256, True), (257, False)])
def test_eval_gate(m, small):
    """M*N*d at the gate (256 queries x 512 components x 2 dims = 2^18)
    evaluates in float64 on both sides; one more query does not."""
    rng = np.random.default_rng(m)
    x, q = rng.normal(size=(2, 512)), rng.normal(size=(2, m))
    pj = kde_tpu.kde(x, [0.3], dtype=jnp.float32)
    pt = kt.kde(x, [0.3], dtype=torch.float32)
    vj, vt = pj(q), pt(q)
    assert isinstance(vj, np.ndarray) == small
    assert vt.dtype == (F64 if small else torch.float32)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj),
                               rtol=1e-12 if small else 2e-4)


@pytest.mark.parametrize("n,small", [(256, True), (257, False)])
def test_sample_gate(n, small):
    """n*(N+n)*d at the gate (256 draws from 768 components in 1-D) draws
    in float64 on both sides; one more draw does not."""
    x = np.random.default_rng(n).normal(size=(1, 768))
    pj = kde_tpu.kde(x, [0.3], dtype=jnp.float32)
    pt = kt.kde(x, [0.3], dtype=torch.float32)
    assert isinstance(kde_tpu.sample(pj, n, key=1)[0], np.ndarray) == small
    pts, ind = kt.sample(pt, n, key=1)
    assert pts.dtype == (F64 if small else torch.float32)
    assert pts.shape == (1, n) and ind.shape == (n,)
    # a generator key never takes the small route
    gen = torch.Generator().manual_seed(1)
    assert kt.sample(pt, n, key=gen)[0].dtype == torch.float32


def test_tensor_query_and_diffop_never_take_the_small_route():
    rng = np.random.default_rng(7)
    x, q = rng.normal(size=(1, 60)), rng.normal(size=(1, 20))
    p = kt.kde(x, [0.3], dtype=torch.float32)
    assert p(q).dtype == F64
    assert p(torch.as_tensor(q, dtype=torch.float32)).dtype == torch.float32
    hooks = dict(addop=(tm.circular_add,), diffop=(tm.circular_diff,),
                 get_mu=(tm.circular_mu,), get_lambda=(tm.circular_lambda,))
    hooked = kt.kde(x, [0.3], **hooks, dtype=torch.float32)
    assert hooked(q).dtype == torch.float32
    assert hooked.evaluate(None, lv_flag=True).dtype == torch.float32
    # a tensor-built density has no host copies: no small route either
    t = kt.KDE(p.points, p.bw, p.weights)
    assert t(q).dtype == torch.float32


@pytest.mark.parametrize("gate", GATES)
def test_gates_equal_kde_tpu_values(gate):
    """The gates are parity settings: at kde_tpu's values, the same calls
    return float64 in both packages."""
    from kde_tpu import config as jconfig
    assert getattr(tconfig, gate) == getattr(jconfig, gate)


def test_golden_row_limit_matches_the_kernel_source():
    """The wrapper's row limit is the kernel's shared-memory bound, and
    the LOOCV gate stays below it."""
    src = ths.SOURCE.read_text()
    assert f"constexpr int kMaxGoldenN = {ths.GOLDEN_MAX_N};" in src
    assert ths.GOLDEN_MAX_N * 8 + 17 * 8 <= 48 * 1024
    assert ths.GOLDEN_MAX_N ** 2 > tconfig.HOST_LOOCV_LIMIT


@pytest.mark.parametrize("gate", GATES)
def test_gate_at_zero_restores_the_density_dtype_route(gate, monkeypatch):
    monkeypatch.setattr(tconfig, gate, 0)
    x, grid = _cfg1(2)
    p = kt.kde(x[None, :])
    small = {"HOST_LOOCV_LIMIT": True, "HOST_EVAL_LIMIT": False,
             "HOST_SAMPLE_LIMIT": True}
    assert (p(grid).dtype == F64) == small[gate]
    assert (p.evaluate(None, lv_flag=True).dtype == F64) == small[gate]
    assert (kt.sample(p, 10, key=0)[0].dtype == F64) == (
        gate != "HOST_SAMPLE_LIMIT")
    if gate == "HOST_LOOCV_LIMIT":
        # the parent's float32 search: within its tolerance, not bitwise
        want = kde_tpu.kde(x[None, :]).host_bw_std()
        np.testing.assert_allclose(p.host_bw_std(), want, rtol=2e-2)
