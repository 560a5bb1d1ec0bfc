"""The kernel-sharded selection's phases ``ops/sharded_select.py`` (K6)
against the JAX package.

The plain twins ``*_ref`` of K6's six phases are composed over S = 1, 2
and 4 simulated shards in one process, with the collectives between them
done by hand (max, sum and stack over the shards), and held to JAX's
``kde_tpu/parallel/gibbs_kernel_sharded.py::_select_sharded`` and its
one-hot stats ``psum`` under ``shard_map`` on a mesh of S CPU devices (the
conftest makes 8), on the same NumPy inputs in float64: the winner's
mean, variance and label equal.  The level is split as
``_KShardPlan`` splits it (padded slots repeat the last node at -inf
log-weight), so the cases include dead rows and shards holding only
padding.  The route (``gibbs_kernel_sharded._route``), the chain blocks
of each route, the twins' count ``TWIN_STAGES`` and the wrapper's checks
are tested here too; the kernels themselves run only on the card
(tests/test_torch_cuda.py)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax, shard_map  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402
from kde_tpu import manifolds as jman  # noqa: E402
from kde_tpu.ops import gibbs as jgibbs  # noqa: E402
from kde_tpu.parallel.gibbs_kernel_sharded import _select_sharded  # noqa: E402
from kde_tpu_torch import manifolds  # noqa: E402
from kde_tpu_torch.ops import gibbs as tgibbs  # noqa: E402
from kde_tpu_torch.ops import sharded_select as ss  # noqa: E402
from kde_tpu_torch.parallel import gibbs_kernel_sharded as gks  # noqa: E402

F64 = torch.float64
KERNELS = "kernels"

# name: (d, w, dn, chains, js, cov, circular dims, dead chains)
CASES = {"cond": (2, 37, 2, 12, (0, 1), False, (), 0),
         "sweep": (3, 29, 3, 10, (1,), True, (), 0),
         "circular": (2, 33, 2, 9, (0, 1), True, (1,), 0),
         "dead_padding": (1, 5, 2, 8, (0, 1), False, (), 3),
         "dead_mixed_dims": (2, 7, 2, 8, (1,), True, (), 2)}


def _case(name, seed=3):
    """One level as NumPy: ``mean``/``bw`` ``[dn, w, d]``, ``logw [dn,
    w]`` (the last two slots of density 0 padding), ``stats [dn, w, 2d+1]``
    (mean, variance, label), ``mu``/``cov`` ``[C, d]`` (cov or None),
    ``active [dn, d]`` (dead_mixed_dims: density 1's first dim off),
    ``u [C, |js|]`` (a 0 and a 1 among them) and the circular dims."""
    d, w, dn, c, js, with_cov, circ, dead = CASES[name]
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=(dn, w, d))
    mu = 0.7 * rng.normal(size=(c, d))
    for k in circ:
        mean[..., k] = rng.uniform(-np.pi, np.pi, size=(dn, w))
        mu[:, k] = rng.uniform(-np.pi, np.pi, size=c)
    mu[:dead] = 1e3                        # far from every candidate: dead
    bw = rng.uniform(0.05, 0.6, size=(dn, w, d))
    wt = rng.uniform(0.1, 1.0, size=(dn, w))
    logw = np.log(wt / wt.sum(axis=-1, keepdims=True))
    logw[0, -2:] = -np.inf
    perm = np.argsort(rng.random((dn, w)), axis=-1).astype(np.float64)
    stats = np.concatenate([mean, bw, perm[..., None]], axis=-1)
    cov = rng.uniform(0.05, 0.3, size=(c, d)) if with_cov else None
    active = np.ones((dn, d), dtype=bool)
    if name == "dead_mixed_dims":
        active[1, 0] = False
    u = rng.uniform(size=(c, len(js)))
    u[0, 0], u[-1, -1] = 0.0, 1.0
    return dict(mean=mean, bw=bw, logw=logw, stats=stats, mu=mu, cov=cov,
                active=active, u=u, js=js, circ=circ)


def _split(x, n_shards, fill=None):
    """``x [dn, w, ...]`` padded to ``n_shards * w_loc`` candidates (the
    last slot repeated, or ``fill``) and cut into shard-major ``[dn, S,
    w_loc, ...]``, as ``_KShardPlan`` lays a level out."""
    w = x.shape[1]
    w_loc = -(-w // n_shards)
    pad = n_shards * w_loc - w
    tail = np.repeat(x[:, -1:], pad, axis=1)
    if fill is not None:
        tail = np.full_like(tail, fill)
    full = np.concatenate([x, tail], axis=1)
    return full.reshape((x.shape[0], n_shards, w_loc) + x.shape[2:])


def _torch_select(case, n_shards):
    """The twins' six phases over ``n_shards`` simulated shards, the
    collectives by hand: the winner's stats ``[|js|, C, 2d+1]``."""
    t = lambda x: None if x is None else torch.as_tensor(x, dtype=F64)
    js = case["js"]
    d = case["mean"].shape[-1]
    diffop = (tuple(manifolds.circular_diff if k in case["circ"]
                    else manifolds.euclid_diff for k in range(d))
              if case["circ"] else None)
    mean, bw, stats = (_split(case[k], n_shards)
                       for k in ("mean", "bw", "stats"))
    logw = _split(case["logw"], n_shards, -np.inf)
    mu, cov, u = t(case["mu"]), t(case["cov"]), t(case["u"])
    active = torch.as_tensor(case["active"])
    rows = [ss.Rows(t(mean[:, s]), t(bw[:, s]), t(logw[:, s]), js, mu, cov,
                    active, diffop) for s in range(n_shards)]
    real = [torch.as_tensor(np.isfinite(logw[js[0]:js[-1] + 1, s]).any(-1))
            for s in range(n_shards)]
    m = [ss.local_max_ref(r) for r in rows]
    m0 = torch.stack(m).amax(dim=0)                                # pmax
    ssum = sum(ss.shifted_sum_ref(r, m0) for r in rows)            # psum
    dm = [ss.dead_max_ref(m0, ssum, m[s], real[s])
          for s in range(n_shards)]
    gmax = torch.stack([x[1] for x in dm]).amax(dim=0)             # pmax
    dead = dm[0][0]
    assert all(torch.equal(x[0], dead) for x in dm)    # replicated
    tots = torch.stack([ss.exp_sum_ref(r, gmax, dead) for r in rows])
    z = sum(ss.count_below_ref(r, gmax, dead, tots, s, u)
            for s, r in enumerate(rows))                           # psum
    sel = sum(ss.owner_stats_ref(t(stats[:, s]), js, z, n_shards, s)
              for s in range(n_shards))                            # psum
    return sel.numpy(), dead.numpy()


def _jax_select(case, n_shards):
    """JAX's ``_select_sharded`` and the one-hot stats ``psum`` of
    ``_run_chain_ks`` under ``shard_map`` on ``n_shards`` CPU devices."""
    js, circ = case["js"], case["circ"]
    d = case["mean"].shape[-1]
    diffop = (tuple(jman.circular_diff if k in circ else jman.euclid_diff
                    for k in range(d)) if circ else None)
    with_cov = case["cov"] is not None
    mu = jnp.asarray(case["mu"])
    cov = jnp.asarray(case["cov"] if with_cov else np.zeros_like(case["mu"]))
    active, u = jnp.asarray(case["active"]), jnp.asarray(case["u"])

    def body(mean, bw, logw, stats):
        mean, bw, logw, stats = mean[:, 0], bw[:, 0], logw[:, 0], stats[:, 0]
        out = []
        for jj, j in enumerate(js):
            def one(mu_c, cov_c, u_c, j=j):
                lg = jgibbs._kernel_logits_raw(mean[j], bw[j], logw[j], mu_c,
                                               cov_c, active[j], diffop,
                                               with_cov=with_cov)
                oh = _select_sharded(u_c, lg, logw[j], n_shards)
                return lax.psum(jnp.sum(jnp.where(oh[:, None], stats[j],
                                                  0.0), axis=0), KERNELS)
            out.append(jax.vmap(one)(mu, cov, u[:, jj]))
        return jnp.stack(out)

    mesh = Mesh(np.array(jax.devices()[:n_shards]), (KERNELS,))
    spec = P(None, KERNELS)
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,) * 4,
                          out_specs=P(), check_vma=False))
    args = [_split(case[k], n_shards) for k in ("mean", "bw")]
    args += [_split(case["logw"], n_shards, -np.inf),
             _split(case["stats"], n_shards)]
    return np.asarray(f(*(jnp.asarray(a) for a in args)))


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_twin_phases_equal_jax_select_sharded(name, n_shards):
    case = _case(name)
    got, dead = _torch_select(case, n_shards)
    want = _jax_select(case, n_shards)
    np.testing.assert_array_equal(got, want)
    if CASES[name][-1]:
        assert dead.any()           # the fallback ran on the dead chains


def test_padding_only_shard_and_dead_rows_draw_real_candidates():
    """With 5 candidates over 4 shards, shard 3 holds only padding; dead
    rows draw uniformly over the real candidates and never a padded slot,
    the shard without a real candidate owns no winner."""
    case = _case("dead_padding")
    assert _split(case["logw"], 4, -np.inf)[0, 3].tolist() == [-np.inf] * 2
    got, dead = _torch_select(case, 4)
    d = case["mean"].shape[-1]
    labels = got[..., 2 * d]
    for jj, j in enumerate(case["js"]):
        real = case["stats"][j, np.isfinite(case["logw"][j]), 2 * d]
        assert np.isin(labels[jj], real).all()
        assert dead[jj, :CASES["dead_padding"][-1]].all()


def _world_plan(n=24, d=2):
    """Two float64 densities on the CPU."""
    import kde_tpu_torch as kt
    rng = np.random.default_rng(9)
    return [kt.kde(rng.normal(size=(d, n)) + s, [0.4], dtype=F64)
            for s in (0.0, 0.5)]


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    import torch.distributed as dist
    from kde_tpu_torch import parallel as par
    store = tmp_path_factory.mktemp("world") / "store"
    par.initialize_multihost(f"file://{store}", 1, 0, backend="gloo",
                             timeout=60)
    try:
        yield par.make_mesh_2d((1, 1))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("user_diffop", [False, True])
def test_cpu_product_takes_the_twins_counted(mesh, monkeypatch, user_diffop):
    """On CPU tensors (and with a user's diffop) every selection stage runs
    on the twins, counted once a stage; no kernel launches.  The user's
    callable computes the Euclidean difference, so the draw is the
    Euclidean one."""
    from kde_tpu_torch.parallel import prod_appx_ms_gibbs_kernel_sharded
    from kde_tpu_torch.ops.balltree import n_levels
    dens = _world_plan()
    n_out, n_iter = 8, 2
    kw = {}
    if user_diffop:
        kw = dict(diffop=(lambda a, b: a - b,))
        assert gks._route(tgibbs.normalize_hooks(
            None, kw["diffop"], None, None, 2), "cuda", 2) == "twin"
    monkeypatch.setattr(ss, "TWIN_STAGES", 0)
    monkeypatch.setattr(ss, "LAUNCHES", 0)
    rng = np.random.default_rng(4)
    L = n_levels(n_out, [p.npts for p in dens])
    bu, bn = tgibbs._stream_sizes(2, 2, L, n_iter)
    ru, rn = rng.uniform(size=n_out * bu), rng.normal(size=n_out * bn)
    pts, idx = prod_appx_ms_gibbs_kernel_sharded(
        mesh, n_out, dens, n_iter=n_iter, rand_u=ru, rand_n=rn, **kw)
    assert ss.TWIN_STAGES == L * (1 + n_iter * 2)
    assert ss.LAUNCHES == 0
    _, want = prod_appx_ms_gibbs_kernel_sharded(
        mesh, n_out, dens, n_iter=n_iter, rand_u=ru, rand_n=rn)
    assert torch.equal(idx, want) and bool(torch.isfinite(pts).all())


def test_route_and_chain_blocks():
    """K6's route keeps no [chains, width] temporary: one block of every
    chain; the twins' blocks are the eager route's, unchanged."""
    circ = (manifolds.circular_add, manifolds.circular_diff,
            manifolds.circular_mu, manifolds.circular_lambda)
    hooks = tgibbs.normalize_hooks(*circ, 1)
    assert gks._route(None, "cuda", 2) == "sharded"
    assert gks._route(hooks, torch.device("cuda", 0), 1) == "sharded"
    assert gks._route(None, "cpu", 2) == "twin"
    assert tgibbs._live_temps("sharded") == 0
    assert tgibbs._live_temps("twin") == tgibbs._LIVE_TEMPS == 8

    class Plan:
        offsets = [(0, 1), (1, 1_000_000)]
    assert tgibbs._chain_block(256, Plan, 4, tgibbs._live_temps("sharded")) \
        == 256
    assert tgibbs._chain_block(256, Plan, 4, tgibbs._live_temps("twin")) \
        == (2 << 30) // (8 * 1_000_000 * 4) == 67


def _rows(dtype=F64, c=4, w=6, d=2, dn=2, js=(0, 1), device="cpu"):
    g = torch.Generator().manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g, dtype=dtype).to(device)
    return ss.Rows(mk(dn, w, d), mk(dn, w, d).abs() + 0.1, mk(dn, w),
                   js, mk(c, d), None, torch.ones((dn, d), dtype=torch.bool),
                   None)


def test_wrapper_refuses_mixed_devices_dtypes_and_shapes():
    rows = _rows()
    m = ss.local_max(rows)
    assert m.shape == (2, 4)
    with pytest.raises(ValueError, match="one CUDA device"):
        ss.local_max(rows._replace(mu=rows.mu.to("meta")))
    with pytest.raises(ValueError, match="one CUDA device"):
        ss.shifted_sum(rows, m.to("meta"))
    with pytest.raises(TypeError):
        ss.local_max(rows._replace(mu=rows.mu.float()))
    with pytest.raises(TypeError):
        ss.local_max(_rows(dtype=torch.float16))
    with pytest.raises(TypeError):
        ss.local_max(rows._replace(active=rows.active.int()))
    with pytest.raises(ValueError):
        ss.local_max(rows._replace(mu=torch.zeros((4, 3), dtype=F64)))
    with pytest.raises(ValueError):
        ss.local_max(rows._replace(js=(0, 2)))
    with pytest.raises(ValueError):
        ss.local_max(rows._replace(js=(1, 2)))
    with pytest.raises(ValueError):
        ss.shifted_sum(rows, m[:1])
    dead = torch.zeros_like(m, dtype=torch.bool)
    with pytest.raises(ValueError):
        ss.exp_sum(rows, m, dead.int())
    tots = ss.exp_sum(rows, m, dead)[None]
    u = torch.full((4, 2), 0.5, dtype=F64)
    assert ss.count_below(rows, m, dead, tots, 0, u).dtype == torch.int64
    with pytest.raises(ValueError):
        ss.count_below(rows, m, dead, tots, 1, u)
    with pytest.raises(ValueError):
        ss.count_below(rows, m, dead, tots.float(), 0, u)
    with pytest.raises(ValueError):
        ss.count_below(rows, m, dead, tots, 0, u.T)
    with pytest.raises(ValueError):
        ss.dead_max(m, m.float(), m, torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError):
        ss.dead_max(m, m, m, torch.ones(3, dtype=torch.bool))
    stats = torch.zeros((2, 6, 5), dtype=F64)
    z = torch.zeros((2, 4), dtype=torch.int64)
    assert ss.owner_stats(stats, (0, 1), z, 1, 0).shape == (2, 4, 5)
    with pytest.raises(ValueError):
        ss.owner_stats(stats.float(), (0, 1), z, 1, 0)
    with pytest.raises(ValueError):
        ss.owner_stats(stats, (0, 1), z.int(), 1, 0)
    with pytest.raises(ValueError):
        ss.owner_stats(stats, (0, 1), z, 2, 2)


def test_shifted_sum_cut_keeps_the_degenerate_test():
    """The one cut of the twin: rows whose global max reaches log(1e-99)
    give 1 in place of their sum, and are live either way."""
    rows = _rows()
    m0 = ss.local_max(rows)
    full = torch.exp(ss._logits(rows) - m0[..., None]).sum(dim=-1)
    cut = ss.shifted_sum(rows, m0)
    live = m0 >= ss.LOG_DEAD
    assert bool(live.all()) and torch.equal(cut, torch.ones_like(cut))
    real = torch.ones(2, dtype=torch.bool)
    for s in (full, cut):
        dead, mfb = ss.dead_max(m0, s, m0, real)
        assert not bool(dead.any()) and torch.equal(mfb, m0)
    low = torch.full_like(m0, -300.0)
    assert torch.equal(ss.shifted_sum(rows, low),
                       torch.exp(ss._logits(rows) + 300.0).sum(dim=-1))
    dead, mfb = ss.dead_max(torch.full_like(m0, -math.inf),
                            torch.zeros_like(m0), m0, torch.tensor([1, 0],
                                                                  dtype=bool))
    assert bool(dead.all())
    assert mfb[0].eq(0).all() and torch.isneginf(mfb[1]).all()


# ---- the card's launch plan, uniform flags and chunked count (pure Python) --

@pytest.mark.parametrize("c,n_js,w,d,item", [
    (256, 1, 1_000_000, 2, 4), (256, 2, 50_000, 2, 4), (256, 1, 50_000, 2, 4),
    (1024, 2, 10_000, 2, 4), (64, 1, 1025, 2, 8), (300, 2, 900, 3, 8),
    (5, 1, 7, 1, 4), (1, 3, 1, 9, 8), (128, 2, 700, 5, 8), (0, 1, 40, 2, 4)])
def test_plan_covers_every_candidate_once_in_chunk_order(c, n_js, w, d, item):
    """Chunks of whole ring slots tile [0, w) in order, each nonempty; a
    tile holds at most MAX_ROWS rows (a power of two), the tiles cover
    every chain of every density, the shared memory fits a block."""
    pl = ss.plan(c, n_js, w, d, item)
    starts = [q * pl.chunk for q in range(pl.chunks)]
    ends = [min(w, s + pl.chunk) for s in starts]
    assert starts[0] == 0 and ends[-1] == w
    assert all(e > s for s, e in zip(starts, ends))
    assert all(ends[q] == starts[q + 1] for q in range(pl.chunks - 1))
    assert pl.chunk % pl.slot == 0 and pl.slot % 32 == 0
    assert pl.slot * (2 * d + 1) * item <= max(ss.SLOT_BYTES,
                                               32 * (2 * d + 1) * item)
    assert pl.rows & (pl.rows - 1) == 0 and 1 <= pl.rows <= ss.MAX_ROWS
    assert pl.tiles == n_js * -(-c // pl.rows)
    assert pl.tiles * pl.rows >= n_js * c
    assert 1 <= pl.chunks <= ss.MAX_CHUNKS
    assert pl.count_group == (32 if pl.chunk <= ss.COUNT_WARP_MAX
                              else ss.COUNT_THREADS)
    assert max(pl.tile_smem, pl.count_smem) <= ss.SMEM_MAX_BYTES
    generic = not 1 <= d <= 3
    assert (pl.count_smem > 0) == generic


def test_plan_fills_the_card_and_bounds_the_scratch():
    """256 chains over a 1M slice fill the 132 SMs (16 row tiles alone
    would leave most SMs idle) with one wave of RESIDENT_PER_SM blocks an
    SM, no block left over for a second; the [rows, chunks] scratch stops
    growing with w; a narrow level is one chunk."""
    big = ss.plan(256, 1, 1_000_000, 2, 4, sms=132)
    assert big.tiles == 16 and 132 <= big.blocks <= ss.RESIDENT_PER_SM * 132
    assert big.blocks > ss.RESIDENT_PER_SM * 132 - big.tiles
    cond = ss.plan(256, 2, 50_000, 2, 4, sms=132)
    assert 132 <= cond.blocks <= ss.RESIDENT_PER_SM * 132
    chunks = [ss.plan(256, 1, w, 2, 4).chunks
              for w in (10 ** 6, 10 ** 7, 10 ** 8, 10 ** 9)]
    assert chunks == [chunks[0]] * 4 and chunks[0] <= ss.MAX_CHUNKS
    few = [ss.plan(1, 1, w, 2, 4).chunks for w in (10 ** 6, 10 ** 8)]
    assert few == [ss.MAX_CHUNKS] * 2
    assert ss.plan(256, 1, 300, 2, 4).chunks == 1
    assert ss.plan(20_000, 2, 20_000, 2, 4).chunks == 1     # tiles enough
    with pytest.raises(ValueError, match="shared memory"):
        ss.plan(256, 1, 2000, 200, 8)
    with pytest.raises(ValueError):
        ss.plan(4, 0, 10, 2, 4)


def test_uniform_dims_compare_bits():
    """A dim is uniform where every candidate has the first's bits: 0.0
    and -0.0 differ (their divisions differ in sign), a repeated NaN is
    uniform (its logit is NaN either way)."""
    bw = torch.full((3, 4, 2), 0.25, dtype=F64)
    bw[1, 2, 0] = 0.5
    bw[2, :, 1] = float("nan")
    assert ss.uniform_dims(bw).tolist() == [[True, True], [False, True],
                                            [True, True]]
    z = torch.zeros((1, 3, 1), dtype=torch.float32)
    z[0, 1, 0] = -0.0
    assert ss.uniform_dims(z).tolist() == [[False]]


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_plan_uniform_flags_per_candidate(n_shards):
    """``_KShardPlan.lvl_uniform`` against a per-candidate check of each
    shard's slice of every level: one point of density 0 has another
    bandwidth in dim 1, so at the leaves dim 1 is uniform on the shards
    that do not hold it and not on the one that does; padded slots
    (repeats of the last node) keep a slice uniform."""
    import kde_tpu_torch as kt
    rng = np.random.default_rng(2)
    n = 13                                   # 13 % 4 != 0: padding
    bw0 = np.full((2, n), 0.4)
    bw0[1, 5] = 0.5
    dens = [kt.kde(rng.normal(size=(2, n)), bw0, dtype=F64),
            kt.kde(rng.normal(size=(2, n)) + 1.0, [0.3, 0.4], dtype=F64)]
    leaf_flags = []
    for shard in range(n_shards):
        plan = gks._KShardPlan(dens, 8, F64, n_shards, shard, "cpu")
        assert tuple(plan.lvl_uniform.shape) == (plan.n_levels, 2, 2)
        for l in range(1, plan.n_levels + 1):
            lvl = plan.level(l)
            assert len(lvl) == 6
            bw = lvl[1][0].numpy()                       # [dn, w, d]
            want = np.array([[all(bw[j, i, k] == bw[j, 0, k]
                                  for i in range(bw.shape[1]))
                              for k in range(2)] for j in range(2)])
            np.testing.assert_array_equal(lvl[5].numpy(), want)
        leaf_flags.append(plan.lvl_uniform[-1].numpy())
    leaf = np.stack(leaf_flags)                          # [S, dn, d]
    assert leaf[:, 0, 0].all() and leaf[:, 1].all()      # dim 0, density 1
    if n_shards > 1:
        assert leaf[:, 0, 1].any() and not leaf[:, 0, 1].all()
    else:
        assert not leaf[0, 0, 1]


def _chunked_count(rows, gmax, dead, tots, sid, u, pl):
    """The card's count_below, step for step in float64 on the twin's
    exps: the chunk sums of exp_sum (each chunk's sum, then the chunks in
    order), the first chunk whose end is not below u, then the scan of that
    chunk from its prefix (w where no chunk reaches u)."""
    e = torch.exp(ss._fallback_logits(rows, dead) - gmax[..., None]).double()
    total, offset = tots.sum(dim=0), tots[:sid].sum(dim=0)
    n_js, c, w = e.shape
    out = torch.full((n_js, c), w, dtype=torch.int64)
    for jj in range(n_js):
        for ci in range(c):
            uu = float(u[ci, jj])
            parts = [float(e[jj, ci, q * pl.chunk:(q + 1) * pl.chunk].sum())
                     for q in range(pl.chunks)]
            run = 0.0
            for q, p in enumerate(parts):
                if not (float(offset[jj, ci]) + (run + p)) \
                        / float(total[jj, ci]) < uu:
                    z = min(w, (q + 1) * pl.chunk)
                    acc = run
                    for i in range(q * pl.chunk, z):
                        acc += float(e[jj, ci, i])
                        if not (float(offset[jj, ci]) + acc) \
                                / float(total[jj, ci]) < uu:
                            z = i
                            break
                    out[jj, ci] = z
                    break
                run += p
    return out


@pytest.mark.parametrize("name", ["cond", "circular", "dead_padding"])
@pytest.mark.parametrize("n_shards", [1, 2])
def test_chunked_count_equals_the_twin(name, n_shards, monkeypatch):
    """The card's chunk search (chunk sums, the crossing chunk, a scan in
    it) gives the twin's count_below on every row, at chunks of one ring
    slot's candidates (many chunks a row), but where the twin's float64
    CDF lies within 1e-12 of u between the two counts (k6_compare's tie
    rule; the case's u = 1 rows are such ties by construction)."""
    monkeypatch.setattr(ss, "SLOT_BYTES", 1)          # 32-candidate slots
    case = _case(name)
    t = lambda x: None if x is None else torch.as_tensor(x, dtype=F64)
    js, d = case["js"], case["mean"].shape[-1]
    diffop = (tuple(manifolds.circular_diff if k in case["circ"]
                    else manifolds.euclid_diff for k in range(d))
              if case["circ"] else None)
    k = -(-65 // case["mean"].shape[1])                # w > 64: chunks > 1
    rep = lambda x: np.concatenate([x] * k, axis=1)
    mean, bw = (_split(rep(case[k]), n_shards) for k in ("mean", "bw"))
    logw = _split(rep(case["logw"]), n_shards, -np.inf)
    mu, cov, u = t(case["mu"]), t(case["cov"]), t(case["u"])
    act = torch.as_tensor(case["active"])
    rows = [ss.Rows(t(mean[:, s]), t(bw[:, s]), t(logw[:, s]), js, mu, cov,
                    act, diffop) for s in range(n_shards)]
    real = [torch.as_tensor(np.isfinite(logw[js[0]:js[-1] + 1, s]).any(-1))
            for s in range(n_shards)]
    m = [ss.local_max_ref(r) for r in rows]
    m0 = torch.stack(m).amax(dim=0)
    ssum = sum(ss.shifted_sum_ref(r, m0) for r in rows)
    dm = [ss.dead_max_ref(m0, ssum, m[s], real[s]) for s in range(n_shards)]
    gmax, dead = torch.stack([x[1] for x in dm]).amax(dim=0), dm[0][0]
    tots = torch.stack([ss.exp_sum_ref(r, gmax, dead) for r in rows])
    for s, r in enumerate(rows):
        pl = ss.plan(mu.shape[0], len(js), r.mean.shape[1], d, 8)
        assert pl.chunks > 1 and pl.chunk == 32
        want = ss.count_below_ref(r, gmax, dead, tots, s, u)
        got = _chunked_count(r, gmax, dead, tots, s, u, pl)
        e = torch.exp(ss._fallback_logits(r, dead)
                      - gmax[..., None]).double()
        cdf = ((tots[:s].sum(dim=0)[..., None] + torch.cumsum(e, dim=-1))
               / tots.sum(dim=0)[..., None])
        for jj, ci in (got != want).nonzero().tolist():
            lo, hi = sorted((int(got[jj, ci]), int(want[jj, ci])))
            gap = (cdf[jj, ci, lo:min(hi, cdf.shape[-1])]
                   - float(u[ci, jj])).abs().max()
            assert float(gap) <= 1e-12
        assert int((got != want).sum()) <= 2


def test_cpu_stage_runs_the_twins():
    """A Stage of CPU tensors (prepare) runs every row phase's twin and
    holds no kernel state; count_below takes it or the rows."""
    rows = _rows()
    st = ss.prepare(rows)
    assert st.device.type == "cpu" and st.plan is None and st.shape == (2, 4)
    m = ss.local_max(st)
    assert torch.equal(m, ss.local_max_ref(rows))
    dead = torch.zeros_like(m, dtype=torch.bool)
    tots = ss.exp_sum(st, m, dead)[None]
    assert torch.equal(tots[0], ss.exp_sum_ref(rows, m, dead))
    u = torch.full((4, 2), 0.5, dtype=F64)
    assert torch.equal(ss.count_below(st, m, dead, tots, 0, u),
                       ss.count_below(rows, m, dead, tots, 0, u))
    with pytest.raises(ValueError, match="one CUDA device"):
        ss.exp_sum(st, m.to("meta"), dead)
