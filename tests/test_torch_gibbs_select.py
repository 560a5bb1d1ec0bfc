"""The Gibbs selection step ``ops/gibbs_select.py`` (K2) against the JAX
package.

``gibbs_select_ref``, the plain twin of the ``gibbs_select`` kernel, is held
to ``kde_tpu/ops/gibbs.py``'s ``_kernel_logits`` + ``_select_label`` and the
``select_stats`` gather, run per chain under ``jax.vmap`` on the same NumPy
inputs: in float64 labels and gathered statistics equal and logits within
1e-12; labels equal except where ``u`` lies on the JAX CDF at the
boundary, within 1e-12 in float64 (``u = 1`` against a total that XLA's
cumsum rounds to 1 and torch's just under it) and 1e-6 in float32 (the
port accumulates the CDF in float64, JAX in float32).  The Gumbel draw is
held to ``argmax(_kernel_logits - log(-log u))`` with ``u`` the twin's
counter noise (``ops/gibbs.py::_gumbel_noise``), itself held to
``threefry2x32`` block by block.  The wrapper's routing, checks
and launch plan, and the chain blocks of each route, are checked here too;
the kernel itself runs only on the card (tests/test_torch_cuda.py)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from fixtures import gibbs_streams  # noqa: E402
from kde_tpu import manifolds as jman  # noqa: E402
from kde_tpu.ops import gibbs as jgibbs  # noqa: E402
from kde_tpu_torch import kde as tkde, manifolds  # noqa: E402
from kde_tpu_torch import prod_appx_ms_gibbs  # noqa: E402
from kde_tpu_torch.ops import gibbs as tgibbs  # noqa: E402
from kde_tpu_torch.ops import gibbs_select as gs  # noqa: E402
from kde_tpu_torch.utils import random as rnd  # noqa: E402

F64, F32 = torch.float64, torch.float32


def _inputs(seed, d, with_cov, circular, dtype, b=2, dn=2, w=40, c=24):
    """One level of ``b`` sets x ``dn`` densities, ``c`` chains, as NumPy:
    a NaN candidate, -inf padding, an inactive and a mixed dim, a
    far-apart chain (dead unless every dim is circular), u at 0 and 1.
    ``circular``: the last dim is an angle."""
    rng = np.random.default_rng(seed)
    codes = tuple(int(circular and k == d - 1) for k in range(d))
    mean = rng.normal(size=(b, dn, w, d))
    mu = 0.7 * rng.normal(size=(b, c, d))
    if circular:
        mean[..., -1] = rng.uniform(-np.pi, np.pi, size=(b, dn, w))
        mu[..., -1] = rng.uniform(-np.pi, np.pi, size=(b, c))
    mean[0, 0, 2, 0] = np.nan
    if not circular or d > 1:
        mu[1, 0, 0] = 1e3                                  # far apart: dead
    bw = rng.uniform(0.05, 0.6, size=(b, dn, w, d))
    wt = rng.uniform(0.1, 1.0, size=(b, dn, w))
    logw = np.log(wt / wt.sum(axis=-1, keepdims=True))
    logw[0, 1, -3:] = -np.inf                             # padding
    logw[1, 0, -1:] = -np.inf
    perm = np.stack([np.stack([rng.permutation(w) for _ in range(dn)])
                     for _ in range(b)])
    active = np.ones((b, dn, d), dtype=bool)
    if d >= 2:
        active[:, 0, d - 1] = False                       # inactive
    active[0, 1, 0] = False                               # mixed over sets
    cov = rng.uniform(0.01, 0.3, size=(b, c, d)) if with_cov else None
    u = rng.uniform(size=(b, c, dn))
    u[0, 1] = 0.0
    u[1, 2] = 1.0
    cast = lambda x: x.astype(np.float32 if dtype == F32 else np.float64)
    arrs = dict(mean=cast(mean), bw=cast(bw), logw=cast(logw), perm=perm,
                mu=cast(mu), cov=None if cov is None else cast(cov),
                active=active, u=cast(u))
    return arrs, codes


def _torch_args(a, js=(0, 1), u=True):
    t = lambda x: None if x is None else torch.as_tensor(x)
    us = t(a["u"][:, :, list(js)]) if u else None
    return (t(a["mean"]), t(a["bw"]), t(a["logw"]), t(a["perm"]), js,
            t(a["mu"]), t(a["cov"]), t(a["active"])), us


def _jax_diffop(codes):
    if not any(codes):
        return None
    return tuple(jman.circular_diff if k else jman.euclid_diff
                 for k in codes)


def _jax_logits(a, codes, bi, j):
    """``kde_tpu``'s ``_kernel_logits`` of set ``bi``, density ``j``, per
    chain under ``jax.vmap``: ``[C, w]``."""
    cov = a["cov"] if a["cov"] is not None else np.zeros_like(a["mu"])
    fn = lambda m, cv: jgibbs._kernel_logits(
        jnp.asarray(a["mean"][bi, j]), jnp.asarray(a["bw"][bi, j]),
        jnp.asarray(a["logw"][bi, j]), m, cv,
        jnp.asarray(a["active"][bi, j]), _jax_diffop(codes),
        with_cov=a["cov"] is not None)
    return jax.vmap(fn)(jnp.asarray(a["mu"][bi]), jnp.asarray(cov[bi]))


@pytest.mark.parametrize("circular", [False, True], ids=["euclid", "circ"])
@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("with_cov", [False, True], ids=["x", "cov"])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_ref_matches_jax_cdf(d, with_cov, dtype, circular):
    """Logits, labels and the gathered mean and variance of every (set,
    chain, density) row against kde_tpu (d = 3 with a circular last dim is
    the SE(2) mix)."""
    a, codes = _inputs(100 * d + 10 * with_cov + circular, d, with_cov,
                       circular, dtype)
    args, u = _torch_args(a)
    mean, var, label = gs.gibbs_select_ref(*args, codes, u=u)
    b, c, n_js, _ = mean.shape
    assert label.shape == (b, c, n_js) and label.dtype == torch.int64
    stage = tgibbs._Stage(args[4], args[5], args[6], u, args[7],
                          a["active"], gs.diffop_of(codes))
    lvl = args[:4]
    tol, bound = (1e-12, 1e-12) if dtype == F64 else (1e-5, 1e-6)
    flips = 0
    for bi in range(b):
        for jj, j in enumerate(args[4]):
            want = np.asarray(_jax_logits(a, codes, bi, j))
            got = stage.logits(j, lvl)
            got = tgibbs._apply_dead_fallback(
                got, lvl[2][:, j], tgibbs._dead_predicate(got))[bi].numpy()
            np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
            fin = np.isfinite(want)
            np.testing.assert_allclose(got[fin], want[fin], rtol=tol,
                                       atol=tol)
            uj = jnp.asarray(a["u"][bi, :, j])
            z = np.asarray(jax.vmap(jgibbs._select_label)(uj, want))
            want_label = a["perm"][bi, j][z]
            same = label[bi, :, jj].numpy() == want_label
            # a flip only where u sits on the JAX CDF at the boundary: u = 1
            # against a total that rounds to 1 or just under it, or (float32)
            # a CDF JAX sums in float32
            cdf = np.asarray(jax.vmap(lambda lg: jnp.cumsum(
                jnp.exp(lg - lg.max()) / jnp.sum(jnp.exp(lg - lg.max()))
            ))(want)).astype(np.float64)
            for ci in np.flatnonzero(~same):
                zt = int(np.flatnonzero(a["perm"][bi, j]
                                        == int(label[bi, ci, jj]))[0])
                lo = min(zt, int(z[ci]))
                assert abs(cdf[ci, lo] - a["u"][bi, ci, j]) < bound
                flips += 1
            zs, keep = z[same], torch.as_tensor(same)
            np.testing.assert_array_equal(
                mean[bi, keep, jj].numpy(), a["mean"][bi, j][zs])
            np.testing.assert_array_equal(
                var[bi, keep, jj].numpy(), a["bw"][bi, j][zs])
    assert flips <= 2


@pytest.mark.parametrize("with_cov", [False, True], ids=["x", "cov"])
@pytest.mark.parametrize("d,circular", [(1, False), (2, False), (1, True),
                                        (3, True)])
def test_ref_matches_jax_gumbel(d, circular, with_cov):
    """The Gumbel draw on the counter noise of chains 40.. and selections
    9, 10: labels equal kde_tpu's ``argmax(_kernel_logits - log(-log u))``
    on the same noise (float64), dead rows included."""
    a, codes = _inputs(7 + d, d, with_cov, circular, F64)
    b, c = a["mu"].shape[:2]
    w = a["logw"].shape[-1]
    seeds = torch.tensor([[7 + d, 0xFFFFFFFF], [123456789, 3]])
    noise = tgibbs._gumbel_noise(seeds, torch.arange(40, 40 + c), (9, 10), w,
                                 F64).numpy()
    args, _ = _torch_args(a, u=False)
    mean, var, label = gs.gibbs_select_ref(*args, codes, seeds=seeds,
                                           chain0=40, sel0=9)
    for bi in range(b):
        for j in range(2):
            lg = np.asarray(_jax_logits(a, codes, bi, j))
            z = np.argmax(lg - np.log(-np.log(noise[bi, :, j])), axis=-1)
            np.testing.assert_array_equal(label[bi, :, j].numpy(),
                                          a["perm"][bi, j][z])
            np.testing.assert_array_equal(mean[bi, :, j].numpy(),
                                          a["mean"][bi, j][z])
            np.testing.assert_array_equal(var[bi, :, j].numpy(),
                                          a["bw"][bi, j][z])


def test_dead_rows_are_uniform_over_real_candidates():
    """The far-apart chain is dead for both densities of set 1: its labels
    are the reference's uniform fallback, which never lands on padding,
    and u = 0 takes the first real candidate."""
    a, codes = _inputs(3, 2, False, False, F64)
    a["u"][1, 0] = 0.0
    args, u = _torch_args(a)
    lvl = args[:4]
    stage = tgibbs._Stage(args[4], args[5], None, u, args[7], a["active"],
                          None)
    for j in range(2):
        assert bool(tgibbs._dead_predicate(stage.logits(j, lvl))[1, 0])
    _, _, label = gs.gibbs_select_ref(*args, codes, u=u)
    assert label[1, 0, 0] == a["perm"][1, 0, 0]
    assert label[1, 0, 1] == a["perm"][1, 1, 0]


def test_single_density_stage_is_a_slice_of_the_conditioning_stage():
    """A sweep stage (one density) selects what the conditioning stage
    (all densities) selects for that density on the same rows."""
    a, codes = _inputs(5, 2, True, False, F64)
    both = gs.gibbs_select_ref(*_torch_args(a)[0], codes,
                               u=_torch_args(a)[1])
    args, u = _torch_args(a, js=(1,))
    one = gs.gibbs_select_ref(*args, codes, u=u)
    for x, y in zip(both, one):
        assert torch.equal(x[:, :, 1:], y)


def test_wrapper_takes_the_twin_on_the_cpu_and_checks_inputs():
    a, codes = _inputs(6, 2, True, True, F32)
    args, u = _torch_args(a)
    n = gs.LAUNCHES
    got = gs.gibbs_select(*args, codes, u=u)
    want = gs.gibbs_select_ref(*args, codes, u=u)
    assert gs.LAUNCHES == n
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    lm, lb, lw, lp, js, mu, cov, act = args
    with pytest.raises(ValueError, match="exactly one"):
        gs.gibbs_select(*args, codes)
    with pytest.raises(ValueError, match="js"):
        gs.gibbs_select(lm, lb, lw, lp, (1, 0), mu, cov, act, codes, u=u)
    with pytest.raises(ValueError, match="codes"):
        gs.gibbs_select(*args, (0, 2), u=u)
    with pytest.raises(ValueError, match="mu"):
        gs.gibbs_select(lm, lb, lw, lp, js, mu[:, :, :1], cov, act, codes,
                        u=u)
    with pytest.raises(TypeError, match="float32 or float64"):
        gs.gibbs_select(lm, lb, lw, lp, js, mu.double(), cov, act, codes,
                        u=u)
    with pytest.raises(TypeError, match="int64"):
        gs.gibbs_select(lm, lb, lw, lp.int(), js, mu, cov, act, codes, u=u)
    assert gs.LAUNCHES == n


def test_diff_codes():
    e, c = manifolds.euclid_diff, manifolds.circular_diff
    assert gs.diff_codes(None, 3) == (0, 0, 0)
    assert gs.diff_codes((e, e, c), 3) == (0, 0, 1)
    assert gs.diff_codes((c,), 1) == (1,)
    assert gs.diff_codes((e, lambda x, y: x - y), 2) is None
    assert gs.diffop_of((0, 0)) is None
    assert gs.diffop_of((0, 1)) == (e, c)


def test_launch_plan():
    """A warp a row up to WARP_MAX_WIDTH, a block above; the logits cached
    where they fit CACHE_MAX_BYTES (float32 at 50,000 candidates, float64
    not); shared memory as the kernel's smem_bytes counts it (per row mu,
    cov, c and log c [d], the cache, d flag bytes)."""
    gcs = lambda *a: tuple(gs.launch_plan(*a)[1:4])   # group, cache, smem
    assert gcs(1, 2, 4) == (32, True, 8 * (8 * 4 + 1 * 4 + 2))
    g, cache, smem = gcs(gs.WARP_MAX_WIDTH, 8, 8)
    assert (g, cache) == (32, True) and smem == 8 * ((32 + 1024) * 8 + 8)
    assert gcs(gs.WARP_MAX_WIDTH + 1, 2, 4)[:2] == (512, True)
    assert gcs(50_000, 2, 4) == (512, True, (50_000 + 8) * 4 + 2)
    assert gcs(50_000, 2, 8) == (512, False, 8 * 8 + 2)
    assert gcs(20_000, 2, 8)[1]
    for w in (1, 1000, 1024, 1025, 25_000, 60_000):
        for d in (1, 2, 8):
            for item in (4, 8):
                assert gcs(w, d, item)[2] <= 226 * 1024


def _counter_word(seed, chain, sel, i):
    """Word ``i`` of the counter stream of (seed, chain, selection), one
    Threefry block at a time in Python ints: the key fold_in(fold_in(seed,
    chain), sel), the block at counter (2q, 2q + 1)."""
    k = rnd.fold_in(*rnd.fold_in(seed[0], seed[1], chain), sel)
    return rnd.threefry2x32(*k, i & ~1, i | 1)[i & 1]


def test_gumbel_noise_is_the_twins_draw():
    """The stage noise is the counter draw, element by element: float32
    candidate i takes word i & 1 of the block at counter (i & ~1, i | 1)
    under fold_in(fold_in(seed, chain), selection), as (w >> 9) | 0x3f800000
    read as a float minus 1; float64 candidate i both words of the block at
    (2i, 2i + 1), its top 52 bits; then the clamp to [tiny, 1 - eps].
    _select_label_gumbel takes the argmax on that noise."""
    seeds = torch.tensor([[3, 0x9E3779B9], [0xFFFFFFFF, 0]])
    chains, sels = torch.tensor([0, 5, 1 << 31]), (2, 0xFFFFFFF0)
    for dtype, w in ((F32, 7), (F64, 4)):
        noise = tgibbs._gumbel_noise(seeds, chains, sels, w, dtype)
        assert noise.shape == (2, 3, 2, w) and noise.dtype == dtype
        fi = np.finfo(np.float32 if dtype == F32 else np.float64)
        for bi in range(2):
            sd = [int(v) for v in seeds[bi]]
            for ci, ch in enumerate(chains.tolist()):
                for si, sel in enumerate(sels):
                    for i in range(w):
                        if dtype == F32:
                            word = _counter_word(sd, ch, sel, i)
                            u = (np.uint32((word >> 9) | 0x3F800000)
                                 .view(np.float32) - np.float32(1))
                        else:
                            hi = _counter_word(sd, ch, sel, 2 * i)
                            lo = _counter_word(sd, ch, sel, 2 * i + 1)
                            m = ((hi << 20) | (lo >> 12)) | 0x3FF0000000000000
                            u = np.uint64(m).view(np.float64) - 1.0
                        u = min(max(u, fi.tiny), 1 - fi.eps)
                        assert float(noise[bi, ci, si, i]) == float(u)
    lg = torch.randn((2, 3, 7), dtype=F32)
    noise = tgibbs._gumbel_noise(seeds, torch.arange(11, 14), (6,), 7, F32)
    want = torch.argmax(lg - torch.log(-torch.log(noise[:, :, 0])), dim=-1)
    assert torch.equal(tgibbs._select_label_gumbel(seeds, lg, 11, 6), want)


def test_twin_stages_count_the_routes_no_kernel_runs():
    """blocked and a user's diffop take the eager twin by design and are
    counted; cdf and gumbel with the package's hooks go through
    gibbs_select."""
    rng = np.random.default_rng(15)
    dens = [tkde(rng.normal(size=(1, 20)), [0.3], dtype=F64)
            for _ in range(2)]
    for select, hooks, counted in (("cdf", {}, False),
                                   ("gumbel", {}, False),
                                   ("blocked", {}, True),
                                   ("cdf", {"diffop": (manifolds.circular_diff,)},
                                    False),
                                   ("cdf", {"diffop": (lambda x, y: x - y,)},
                                    True)):
        n = gs.TWIN_STAGES
        prod_appx_ms_gibbs(8, dens, key=0, select=select, **hooks)
        assert (gs.TWIN_STAGES > n) == counted, (select, hooks)


def test_custom_diffop_twin_equals_kernel_route():
    """A user's diffop doing Euclidean arithmetic takes the eager twin and
    draws exactly the product the gibbs_select route draws, cdf and
    gumbel."""
    rng = np.random.default_rng(16)
    dens = [tkde(rng.normal(size=(2, 30)), [0.3], dtype=F64)
            for _ in range(2)]
    for select in ("cdf", "gumbel"):
        a = prod_appx_ms_gibbs(16, dens, key=1, select=select,
                               diffop=(lambda x, y: x - y,))
        b = prod_appx_ms_gibbs(16, dens, key=1, select=select)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_chain_block_per_route():
    """The twin route keeps ~_LIVE_TEMPS [chains, width] temporaries, the
    kernels none (gumbel draws its noise inside them): at the 2 x 20,000
    slice (width 20,000, float32) the twin runs 20,000 chains in 6 blocks,
    the kernels in one.  cdf and gumbel on the card with Euclidean hooks
    take the chain kernel, a circular diffop alone (no circular quadruple)
    gibbs_select."""
    diff = lambda ops: (None, ops, None, None)
    assert tgibbs._route("cdf", None, "cuda", 2, 1) == "chain"
    assert tgibbs._route("gumbel", None, "cuda", 2, 1) == "chain"
    assert tgibbs._route("gumbel", diff((manifolds.circular_diff,)),
                         "cuda", 2, 1) == "kernel"
    assert tgibbs._route("cdf", diff((manifolds.circular_diff,)),
                         "cuda", 2, 1) == "kernel"
    assert tgibbs._route("blocked", None, "cuda", 2, 1) == "twin"
    assert tgibbs._route("cdf", diff((lambda x, y: x - y,)), "cuda", 2,
                         1) == "twin"
    assert tgibbs._route("cdf", None, "cpu", 2, 1) == "twin"
    live = {r: tgibbs._live_temps(r) for r in ("twin", "kernel", "chain")}
    assert live == {"twin": tgibbs._LIVE_TEMPS, "kernel": 0, "chain": 0}
    blocks = lambda live: -(-20_000 // tgibbs._chains_per_block(
        20_000, 20_000, 4, live))
    assert (blocks(8), blocks(0)) == (6, 1)


@pytest.mark.parametrize("route", ["twin", "kernel"])
def test_chain_blocking_is_layout_only_on_each_route(route, monkeypatch):
    """Replay products with every chain in one block and with the budget
    at 1 byte (one chain a block on the twin route; the kernel's cdf keeps
    no [chains, width] temporary, so all chains stay one block) are
    identical, and equal across the routes."""
    rng = np.random.default_rng(12)
    d, ns, n_out, n_iter = 2, (20, 30), 50, 2
    dens = [tkde(rng.normal(size=(d, n)), [0.4], dtype=F64) for n in ns]
    ru, rn, _ = gibbs_streams(rng, 2, d, n_out, n_iter, max(ns + (n_out,)))
    one = prod_appx_ms_gibbs(n_out, dens, n_iter=n_iter, rand_u=ru,
                             rand_n=rn, record_labels=True)
    monkeypatch.setattr(tgibbs, "_route", lambda *a: route)
    monkeypatch.setattr(tgibbs, "CHAIN_BLOCK_BYTES", 1)
    plan = tgibbs._get_plan(dens, n_out, F64, torch.device("cpu"))
    live = tgibbs._live_temps(route)
    assert tgibbs._chain_block(n_out, plan, 8, live) == \
        (1 if route == "twin" else n_out)
    blocked = prod_appx_ms_gibbs(n_out, dens, n_iter=n_iter, rand_u=ru,
                                 rand_n=rn, record_labels=True)
    for a, b in zip(one, blocked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_two_pi_as_torch_rounds_the_scalar():
    tp, inv = gs._two_pi(F32)
    assert tp == float(np.float32(2 * math.pi))
    assert inv == float(np.float32(1.0) / np.float32(2 * math.pi))
    assert gs._two_pi(F64) == (2 * math.pi, 1.0 / (2 * math.pi))


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_dead_shortcut_gives_the_twins_dead_predicate(dtype):
    """The kernels' gumbel draw takes the sum of exps only where a row's
    max lies below log(1e-99) (in the chain's type): the sum holds exp(0)
    = 1, so a row whose max reaches the threshold is live.  On rows
    engineered around the threshold (the max a few ulps either side of it,
    with 0 to 4000 other candidates just under the max, so that the log of
    the sum carries rows below the threshold over it), the shortcut gives
    ``_dead_predicate`` row for row, and both kinds of row below the
    threshold occur."""
    thr = torch.tensor(gs.LOG_DEAD, dtype=dtype)
    rows = []
    for steps in range(-6, 7):
        mx = thr.clone()
        for _ in range(abs(steps)):
            mx = torch.nextafter(mx, torch.tensor(
                math.inf if steps > 0 else -math.inf, dtype=dtype))
        for others in (0, 1, 3, 100, 4000):
            for gap in (0.0, 1e-6, 1e-3, 1.0, 50.0):
                row = torch.full((4001,), -math.inf, dtype=dtype)
                row[0] = mx
                row[1:1 + others] = mx - gap
                rows.append(row)
    lg = torch.stack(rows)[None]
    full = tgibbs._dead_predicate(lg)
    short = ~(lg.max(dim=-1).values >= thr) & full
    assert torch.equal(short, full)
    below = ~(lg.max(dim=-1).values >= thr)
    assert bool(full[below].any()) and bool((~full[below]).any())
    assert not bool(full[~below].any())


@pytest.mark.parametrize("route", ["twin", "kernel"])
def test_gumbel_draw_does_not_depend_on_chain_blocks(route, monkeypatch):
    """A keyed gumbel product on the chain route (one call for every
    chain) is the same on the twin route with CHAIN_BLOCK_BYTES at 1 byte
    (one chain a block) and on the stage route in blocks of 7 chains (the
    kernels keep no [chains, width] temporary, so the budget alone never
    splits them): the noise is a function of the chain's global index, not
    of its block or launch.  The same key draws the same product; another
    key another one."""
    rng = np.random.default_rng(17)
    dens = [tkde(rng.normal(size=(2, n)) + s, [0.4], dtype=F64)
            for n, s in ((40, 0.0), (30, 0.5))]
    draw = lambda key=3: prod_appx_ms_gibbs(50, dens, n_iter=2, key=key,
                                            select="gumbel",
                                            record_labels=True)
    monkeypatch.setattr(tgibbs, "_route", lambda *a: "chain")
    one = draw()
    for x, y in zip(one, draw()):
        assert torch.equal(x, y)
    assert not torch.equal(one[1], draw(4)[1])
    monkeypatch.setattr(tgibbs, "_route", lambda *a: route)
    monkeypatch.setattr(tgibbs, "CHAIN_BLOCK_BYTES", 1)
    plan = tgibbs._get_plan(dens, 50, F64, torch.device("cpu"))
    assert tgibbs._chain_block(50, plan, 8, tgibbs._live_temps(route)) == \
        (1 if route == "twin" else 50)
    if route == "kernel":
        monkeypatch.setattr(tgibbs, "_chain_block", lambda *a: 7)
    for x, y in zip(one, draw()):
        assert torch.equal(x, y)


@pytest.mark.parametrize("item", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("d", list(range(1, 18)))
def test_launch_plan_tiles_fit_and_cover(d, item):
    """Every shape maps to one layout: cdf over a level wider than
    WARP_MAX_WIDTH with at least TILE_MIN_ROWS rows takes the tiles, gumbel
    never, the rest the warp or block layout; a block's shared memory stays
    within the card's 227 KB at d = 1-17 in both dtypes (the kernel's
    tile_smem: chunk sums, a ring of bandwidths and their logs, the rows'
    constants where d > 3); the chunks are whole ring slots, at most
    MAX_CHUNKS, and cover the level once, in order."""
    rmin = gs.TILE_MIN_ROWS
    for w in (1, 1000, gs.WARP_MAX_WIDTH, gs.WARP_MAX_WIDTH + 1, 4097,
              20_000, 33_000, 50_000, 1_000_000):
        for rows in (1, rmin - 1, rmin, 20_000):
            for gumbel in (False, True):
                p = gs.launch_plan(w, d, item, rows=rows, gumbel=gumbel)
                tiles = (not gumbel and w > gs.WARP_MAX_WIDTH
                         and rows >= rmin)
                want = ("tiles" if tiles else
                        "warp" if w <= gs.WARP_MAX_WIDTH else "block")
                assert p.layout == want, (w, rows, gumbel, p)
                assert p.smem <= 227 * 1024 and p.smem <= gs.SMEM_MAX_BYTES
                if p.layout != "tiles":
                    assert (p.chunk, p.chunks, p.slot) == (w, 1, 0)
                    continue
                assert p.group == 32 and p.rows == gs.TILE_ROWS
                assert not p.cache
                assert p.slot >= 32 and p.slot % 32 == 0
                assert p.chunk % p.slot == 0 and p.chunks <= gs.MAX_CHUNKS
                bounds = [(k * p.chunk, min(w, (k + 1) * p.chunk))
                          for k in range(p.chunks)]
                assert bounds[0][0] == 0 and bounds[-1][1] == w
                assert all(lo < hi for lo, hi in bounds)
                assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
                generic = not 1 <= d <= 3
                smem = (p.rows * p.chunks * 8
                        + gs.STAGES * p.slot * (3 * d + 1) * item
                        + (p.rows * (4 * d * item + d) if generic else 0))
                assert p.smem == smem


def test_launch_plan_forced_layouts():
    """``--k2-diag``'s forced layouts: tiles of fewer rows where a block's
    shared memory cannot hold 16 rows' constants (``_tile_plan`` of 8 rows
    as of 16 otherwise), the block layout where one row's cannot; gumbel
    has no tiles."""
    p = gs._tile_plan(20_000, 2, 4, 8)
    assert (p.layout, p.rows, p.group, p.cache) == ("tiles", 8, 32, False)
    assert gs.launch_plan(20_000, 2, 4, layout="tiles").rows == gs.TILE_ROWS
    assert gs.launch_plan(20_000, 2, 4, layout="block").layout == "block"
    assert gs.launch_plan(2000, 2, 4, layout="warp").cache
    assert not gs.launch_plan(20_000, 2, 4, layout="warp").cache
    p = gs.launch_plan(20_000, 90, 8, rows=20_000)
    assert p.layout == "tiles" and p.rows < gs.TILE_ROWS
    assert gs.launch_plan(20_000, 200, 8, rows=20_000).layout == "block"
    with pytest.raises(ValueError, match="gumbel"):
        gs.launch_plan(20_000, 2, 4, gumbel=True, layout="tiles")
    with pytest.raises(ValueError, match="layout"):
        gs.launch_plan(20_000, 2, 4, layout="staged")


def _tile_rows(plan, b, c, n_js):
    """The rows each block of a tile launch over ``b`` sets, ``c`` chains
    and ``n_js`` densities holds, as csrc/gibbs_select.cu's ``k2_tiles``
    walks them: ``[blocks, plan.rows]`` indices into the ``(b, c, jj)``
    row order of the outputs, -1 where a tile runs past the chains.
    Blocks walk the (set, density) slabs in order, each slab's chains in
    tiles of ``plan.rows``."""
    tiles = -(-c // plan.rows)
    slab = np.arange(b * n_js)[:, None, None]
    chain = (np.arange(tiles)[None, :, None] * plan.rows
             + np.arange(plan.rows)[None, None, :])
    row = (slab // n_js * c + chain) * n_js + slab % n_js
    return np.where(chain < c, row, -1).reshape(-1, plan.rows)


@pytest.mark.parametrize("b,c,n_js", [(1, 20_000, 1), (2, 1027, 2),
                                      (3, 16, 1), (1, 5, 3)])
def test_tile_rows_share_their_set_and_density(b, c, n_js):
    """A tile's rows are chains of one (set, density), consecutive, in the
    outputs' (b, c, jj) order; every row lies in exactly one tile, and only
    the last tile of a slab runs past the chains."""
    p = gs.launch_plan(20_000, 2, 4, rows=max(gs.TILE_MIN_ROWS, b * c * n_js))
    rows = _tile_rows(p, b, c, n_js)
    tiles = -(-c // p.rows)
    assert rows.shape == (b * n_js * tiles, p.rows)
    real = rows[rows >= 0]
    assert np.array_equal(np.sort(real), np.arange(b * c * n_js))
    bi, ci, jj = real // (c * n_js), real // n_js % c, real % n_js
    for blk in rows:
        r = blk[blk >= 0]
        slab = {(int(x) // (c * n_js), int(x) % n_js) for x in r}
        assert len(slab) == 1
        ch = r // n_js % c
        assert np.array_equal(ch, np.arange(ch[0], ch[0] + len(ch)))
    assert int((rows < 0).sum()) == b * n_js * (tiles * p.rows - c)
    assert bi.max() == b - 1 and jj.max() == n_js - 1 and ci.max() == c - 1


def test_wrapper_rejects_a_malformed_uniform():
    """uniform is [B, dn, d], bool or uint8, on the inputs' device; the
    twin ignores it (the CPU's labels are the same with or without)."""
    a, codes = _inputs(6, 2, True, True, F32)
    args, u = _torch_args(a)
    lm, lb, lw, lp, js, mu, cov, act = args
    b, dn, w, d = lm.shape
    uni = torch.ones((b, dn, d), dtype=torch.bool)
    want = gs.gibbs_select(*args, codes, u=u)
    for flags in (uni, uni.to(torch.uint8), torch.zeros_like(uni)):
        got = gs.gibbs_select(*args, codes, u=u, uniform=flags)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="uniform"):
        gs.gibbs_select(*args, codes, u=u, uniform=uni[:, :, :1])
    with pytest.raises(ValueError, match="uniform"):
        gs.gibbs_select(*args, codes, u=u, uniform=uni[0])
    with pytest.raises(TypeError, match="uniform"):
        gs.gibbs_select(*args, codes, u=u, uniform=uni.float())
    with pytest.raises(ValueError, match="device"):
        gs.gibbs_select(*args, codes, u=u, uniform=uni.to("meta"))


def test_run_chain_passes_each_levels_uniform_flags(monkeypatch):
    """On the stage route every selection (conditioning without cov,
    sweeps with) gets its level's flags, [B, dn, d], equal to a check of
    every candidate's bandwidth at that level, padded slots included (two
    densities of 30 and 41 points); a level whose leaves share one
    bandwidth in dim 0 but not in dim 1 is flagged in dim 0 alone."""
    rng = np.random.default_rng(21)
    dens = []
    for n in (30, 41):
        var = np.stack([np.full(n, 0.09), rng.uniform(0.05, 0.2, n)], 1)
        dens.append(tgibbs.KDE(rng.normal(size=(n, 2)), var, np.ones(n) / n,
                               True, device="cpu", dtype=F64))
    seen, real = [], gs.gibbs_select

    def spy(*args, **kw):
        seen.append((args[1], args[6] is not None, kw["uniform"]))
        return real(*args, **kw)
    monkeypatch.setattr(gs, "gibbs_select", spy)
    monkeypatch.setattr(tgibbs, "_route", lambda *a: "kernel")
    prod_appx_ms_gibbs(12, dens, n_iter=2, key=3)
    assert seen and {c for _, c, _ in seen} == {False, True}
    one_dim = 0
    for bw, _, uni in seen:
        assert uni.shape == (1, 2, 2)
        want = (bw == bw[:, :, :1]).all(dim=2)
        assert torch.equal(uni.bool(), want)
        one_dim += int(bool((uni[..., 0].bool() & ~uni[..., 1].bool())
                            .any()))
    assert one_dim > 0


def test_replay_product_of_more_densities_than_the_chain_kernel(monkeypatch):
    """MAX_DENS + 1 = 17 one-dimensional densities of about 40 points, in
    float64: more than the chain kernel takes, so on the card the stage
    route (one gibbs_select a selection step, forced here on the CPU,
    where it runs the twin); trace-exact against kde_tpu and the serial
    oracle (test_torch_gibbs's check: labels equal, points to 1e-9), every
    selection handed its level's uniform flags."""
    import kde_tpu
    from kde_tpu_torch.ops import gibbs_chain
    from test_torch_gibbs import _check_replay
    dn = gibbs_chain.MAX_DENS + 1
    rng = np.random.default_rng(22)
    jdens = [kde_tpu.kde(rng.normal(size=(1, 38 + j % 5)) + 0.05 * j, [0.5])
             for j in range(dn)]
    n_out, n_iter = 8, 1
    ru, rn, _ = gibbs_streams(rng, dn, 1, n_out, n_iter, 42)
    assert tgibbs._route("cdf", None, "cuda", dn, 1) == "kernel"
    calls, real = [], gs.gibbs_select

    def spy(*args, **kw):
        calls.append(kw["uniform"] is not None)
        return real(*args, **kw)
    monkeypatch.setattr(gs, "gibbs_select", spy)
    monkeypatch.setattr(tgibbs, "_route", lambda *a: "kernel")
    _check_replay(jdens, n_out, n_iter, ru, rn)
    n_levels = int(np.floor(np.log2(42) + 1))
    assert len(calls) == n_levels * (1 + n_iter * dn) and all(calls)
