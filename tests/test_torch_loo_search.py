"""K4's plain twin (``kde_tpu_torch/ops/loo_search.py::loo_search_ref``)
and ``ops/loocv.py::ksize_rows`` against the JAX package's golden search
(``kde_tpu/ops/loocv.py::_ksize_search`` / ``ksize_rows`` /
``ksize_bandwidths`` / ``device_fit_arrays``) on the CPU.

float64 is held at rtol 1e-10: the same trajectory over entropies that
agree to ~1e-15.  The float32 tiled route is held against kde_tpu's Pallas
route in interpret mode within the search's own tolerance 1e-2.  On the
CPU the wrapper ``loo_search`` runs the twin and launches nothing."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import kde_tpu  # noqa: E402
from kde_tpu.ops import loocv as jloocv  # noqa: E402
from kde_tpu.ops import pallas_eval as jpallas  # noqa: E402
from kde_tpu_torch import config as tconfig  # noqa: E402
from kde_tpu_torch.ops import loo_search as tls  # noqa: E402
from kde_tpu_torch.ops import loocv as tloocv  # noqa: E402

F64, F32 = torch.float64, torch.float32
TOL = 1e-2

# (rows R, points n, zero-weight points): d = 1, 2, 3; R = B * d = 6 rows
# of two sets sharing one weight vector; n = 1, 2 and 3; a zero-weight
# tail
CASES = {"d1": (1, 150, 0), "d2": (2, 150, 0), "d3": (3, 120, 0),
         "batched_2x3": (6, 100, 0), "n1": (2, 1, 0), "n2": (3, 2, 0),
         "n3": (3, 3, 0), "zero_tail": (2, 200, 40),
         "2x256": (2, 256, 0), "12x1000": (12, 1000, 0)}


def _case(name, seed=0):
    r, n, zero = CASES[name]
    rng = np.random.default_rng(seed + r * 1000 + n)
    rows = rng.normal(size=(r, n)) * rng.uniform(0.3, 3.0, size=(r, 1))
    w = rng.uniform(0.2, 1.0, size=n)
    w[n - zero:] = 0.0
    return rows, w / w.sum()


def _bracket(rows, dtype):
    t = torch.as_tensor(rows, dtype=dtype)
    lo, hi = tloocv._slices_on(t.shape[1], t.device)
    return (t, lo, hi) + tuple(tloocv.bracket_rows(t, lo, hi))


def _jax_search(rows, w, base, ax, bx, cx, impl, chunk):
    """kde_tpu's jitted search as its fits run it (unrolled and
    speculative on the dense route)."""
    r, n = rows.shape
    return np.asarray(jloocv._ksize_search(
        *(jnp.asarray(np.asarray(x)) for x in (rows, base ** 2, w, ax, bx,
                                                cx)),
        tol=TOL, impl=impl, chunk=chunk, unroll=jloocv.golden_unroll(impl),
        lookahead=jloocv.golden_lookahead(impl, r, n)))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("impl", ["dense", "chunk"])
def test_twin_matches_jax_search_f64(name, impl):
    rows, w = _case(name)
    t, lo, hi, base, ax, bx, cx = _bracket(rows, F64)
    wt = torch.as_tensor(w)
    got = tls.loo_search_ref(t, wt, base ** 2, ax, bx, cx, tol=TOL,
                             impl=impl, chunk=64)
    want = _jax_search(rows, w, base.numpy(), ax.numpy(), bx.numpy(),
                       cx.numpy(), impl, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    bw = tloocv.ksize_rows(t, wt, lo, hi, tol=TOL, impl=impl, chunk=64)
    jbw = jloocv.ksize_rows(jnp.asarray(rows), jnp.asarray(w),
                            jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
                            tol=TOL, impl=impl, chunk=64)
    np.testing.assert_allclose(bw.numpy(), np.asarray(jbw), rtol=1e-10)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_fits_match_jax(d, monkeypatch):
    """ksize_bandwidths above the small gate and device_fit_arrays (the
    `*` refit's fit) go through loo_search and select kde_tpu's
    bandwidths."""
    monkeypatch.setattr(kde_tpu.config, "HOST_LOOCV_LIMIT", 0)
    monkeypatch.setattr(tconfig, "HOST_LOOCV_LIMIT", 0)
    rows, w = _case(f"d{d}", seed=7)
    before = tls.LAUNCHES
    got = tloocv.ksize_bandwidths(rows.T, w, dtype=F64)
    np.testing.assert_allclose(got, jloocv.ksize_bandwidths(rows.T, w),
                               rtol=1e-10)
    tp, tv, tw = tloocv.device_fit_arrays(torch.as_tensor(rows), w)
    jp, jv, jw = jloocv.device_fit_arrays(jnp.asarray(rows), jnp.asarray(w))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-15)
    assert tls.LAUNCHES == before


def test_tiled_route_f32_matches_jax_pallas(monkeypatch):
    """With the gate at 1 float32 rows take the tiled route (K1's twin on
    the CPU); kde_tpu takes its Pallas route, run in interpret mode as its
    own tests run it, with its search in float32."""
    monkeypatch.setattr(tconfig, "LOOCV_PAIR_LIMIT", 1)
    monkeypatch.setattr(jpallas, "pallas_log_eval", functools.partial(
        jpallas.pallas_log_eval, interpret=True))
    rows, w = _case("d2", seed=3)
    rows = rows[:, :130]
    w = w[:130] / w[:130].sum()
    t, lo, hi, base, ax, bx, cx = _bracket(rows, F32)
    impl = tloocv.select_loo_impl(130, F32)
    assert impl == "tiled"
    got = tls.loo_search_ref(t, torch.as_tensor(w, dtype=F32), base ** 2,
                             ax, bx, cx, tol=TOL, impl=impl)
    with jax.enable_x64(False):
        want = _jax_search(rows.astype(np.float32), w.astype(np.float32),
                           base.numpy(), ax.numpy(), bx.numpy(), cx.numpy(),
                           "pallas", 1024)
    assert want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL)


def test_lone_live_point_gives_inf_entropy():
    """A positive-weight point without a positive-weight neighbour has
    p = 0, so every probe's entropy is +inf (the zero-likelihood guard),
    and the search follows kde_tpu's through the infinite values."""
    rows, _ = _case("d2", seed=5)
    w = np.zeros(rows.shape[1])
    w[0] = 0.5                           # one live point, weights unnormed
    t, lo, hi, base, ax, bx, cx = _bracket(rows, F64)
    wt = torch.as_tensor(w)
    trace = tls.new_trace(t, TOL)
    got = tls.loo_search(t, wt, base ** 2, ax, bx, cx, tol=TOL, trace=trace)
    f = trace[:, :, 1]
    seen = ~torch.isnan(trace[:, :, 0])
    assert bool(torch.isposinf(f[seen]).all())
    want = _jax_search(rows, w, base.numpy(), ax.numpy(), bx.numpy(),
                       cx.numpy(), "dense", 1024)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_wrapper_runs_the_twin_on_cpu(dtype):
    """CPU tensors: loo_search is loo_search_ref bit for bit, LAUNCHES
    stays 0 and the trace holds each row's probes, x1 and x2 first, with
    the twin's entropies at them."""
    rows, w = _case("zero_tail")
    t, lo, hi, base, ax, bx, cx = _bracket(rows, dtype)
    wt = torch.as_tensor(w, dtype=dtype)
    before = tls.LAUNCHES
    trace = tls.new_trace(t, TOL)
    got = tls.loo_search(t, wt, base ** 2, ax, bx, cx, tol=TOL,
                         impl="chunk", chunk=64, trace=trace)
    assert tls.LAUNCHES == before == 0
    want = tls.loo_search_ref(t, wt, base ** 2, ax, bx, cx, tol=TOL,
                              impl="chunk", chunk=64)
    assert torch.equal(got, want)
    nloo = tls.make_nloo(t, base ** 2, wt, "dense", 1024)
    x = trace[:, :, 0]
    probes = (~torch.isnan(x)).sum(dim=1)
    assert bool((probes >= 3).all())
    for k in range(int(probes.max())):
        live = ~torch.isnan(x[:, k])
        xk = torch.where(live, x[:, k], torch.ones_like(x[:, k]))
        np.testing.assert_allclose(trace[live, k, 1].numpy(),
                                   nloo(xk)[live].numpy(),
                                   rtol=1e-12 if dtype == F64 else 1e-5)
    # the pick is the row's best probe: golden section keeps it as x1 or x2
    f = torch.where(torch.isnan(x), torch.full_like(x, float("inf")),
                    trace[:, :, 1])
    best = x[torch.arange(len(got)), f.argmin(dim=1)]
    assert torch.equal(got, best)


def test_wrapper_checks_its_inputs():
    rows, w = _case("d2")
    t, lo, hi, base, ax, bx, cx = _bracket(rows, F64)
    wt = torch.as_tensor(w)
    with pytest.raises(TypeError):
        tls.loo_search(t, wt.float(), base ** 2, ax, bx, cx)
    with pytest.raises(ValueError):
        tls.loo_search(t, wt[:-1], base ** 2, ax, bx, cx)
    with pytest.raises(ValueError):
        tls.loo_search(t, wt, base ** 2, ax[:1], bx, cx)
    with pytest.raises(ValueError):
        tls.loo_search(t, wt, base ** 2, ax, bx, cx,
                       trace=torch.zeros(2, 3, 2, dtype=F64))


TILE = 1024      # columns a tile (csrc/loo_probe.cuh's kTile)


def _plan_groups(plan, n):
    """The query groups ``[g0, g1)`` of each block of a row on a rows plan
    (csrc/loo_search.cu's loo_rows_kernel: block k takes a contiguous run
    of groups_per_block)."""
    g, gpb = tls.n_groups(n), plan.groups_per_block
    return [(k * gpb, min(g, (k + 1) * gpb))
            for k in range(plan.blocks_per_row)]


def _plan_tiles(plan, n):
    """The column ranges ``[c0, c1)`` a query's pass takes: on the rows
    plan tiles of TILE columns, the last one ending at the row's last
    column (rows_group's loop); on the grid plan whole tiles past it."""
    end = n if plan.layout == "rows" else -(-n // TILE) * TILE
    return [(c, min(c + TILE, end)) for c in range(0, end, TILE)]


# launch_plan's shapes: (rows, points, dtype); the rows plan's small
# rows, the tile edges, N = 1, 2, 3, MAX_ROWS rows, and the grid plan's
# large rows
PLAN_SHAPES = [(2, 256, F32), (2, 1000, F32), (12, 1000, F32),
               (2, 1100, F32), (2, 2048, F32), (2, 4096, F32),
               (3, 4096, F32), (2, 16384, F32), (12, 16384, F32),
               (1, 1023, F32), (1, 1025, F32), (2, 3071, F32),
               (1, 1, F32), (3, 2, F32), (6, 3, F64), (1024, 256, F32),
               (1024, 1000, F64), (2, 1000, F64), (2, 8192, F64),
               (2, 16384, F64), (2, 20000, F32), (8, 20000, F32),
               (1, 100000, F32), (2, 20000, F64)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("r,n,dtype", PLAN_SHAPES)
def test_launch_plan_covers_every_query_once(r, n, dtype, sms):
    """The rows plan gives every query group of a row to exactly one of
    its blocks (so every query, groups of GROUP), its passes cover the
    live columns and stop at the last one, a cluster has at most
    ROWS_MAX_CLUSTER (<= 16) blocks, a grid that meets at per-row counters
    is at most one block an SM (a cooperative launch holds it at once),
    and a block's shared memory fits; other rows take the grid plan, whose
    tiles run past the row's end in whole tiles."""
    plan = tls.launch_plan(r, n, dtype, sms)
    g = tls.n_groups(n)
    tiles = _plan_tiles(plan, n)
    assert tiles[0][0] == 0 and all(
        a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
    assert all(0 < c1 - c0 <= TILE for c0, c1 in tiles)
    itemsize = 8 if dtype == F64 else 4
    if plan.layout == "grid":
        assert n > tls.ROWS_MAX_N[dtype] or tls.rows_smem(n, 1, itemsize) > \
            tls.ROWS_SMEM
        assert tiles[-1][1] >= n and tiles[-1][1] % TILE == 0
        return
    assert n <= tls.ROWS_MAX_N[dtype] and tiles[-1][1] == n
    groups = _plan_groups(plan, n)
    assert len(groups) == plan.blocks_per_row and all(
        g1 > g0 for g0, g1 in groups)
    owner = [k for k, (g0, g1) in enumerate(groups) for _ in range(g0, g1)]
    assert len(owner) == g and owner == sorted(owner)
    queries = np.bincount([i // tls.GROUP for i in range(n)], minlength=g)
    assert queries.sum() == n and bool((queries > 0).all())
    assert 1 <= plan.teams <= min(tls.ROWS_MAX_TEAMS, plan.groups_per_block)
    assert plan.cluster == (plan.blocks_per_row <= tls.ROWS_MAX_CLUSTER)
    assert tls.ROWS_MAX_CLUSTER <= 16
    if not plan.cluster:
        assert r * plan.blocks_per_row <= sms
    assert plan.smem == tls.rows_smem(n, plan.groups_per_block, itemsize)
    assert plan.smem <= tls.ROWS_SMEM


def test_launch_plan_spreads_a_sweep_over_the_card():
    """Where a sweep has at least a group an SM, the rows plan's blocks
    (at most one an SM) carry at most one group more than the even
    share."""
    for r, n in [(2, 4096), (12, 1000), (3, 4096), (2, 16384), (1, 16384)]:
        plan = tls.launch_plan(r, n, F32, 132)
        share = -(-r * tls.n_groups(n) // 132)
        assert plan.layout == "rows"
        assert r * plan.blocks_per_row <= 132
        assert plan.groups_per_block <= share + 1

