"""The chain kernel's twin and wrapper (``kde_tpu_torch/ops/gibbs_chain.py``)
on the CPU.

``gibbs_chain_ref`` (what ``gibbs_chain`` runs for CPU tensors) is
trace-exact in float64 against ``kde_tpu.prod_appx_ms_gibbs`` with injected
streams and against the serial oracle
``kde_tpu.reference_impl.serial_gibbs_product``: labels equal, points to
rtol 1e-9 / atol 1e-12 (the tolerance of tests/test_replay_parity.py).  A
NumPy emulation of ``csrc/gibbs_chain.cu``'s per-chain arithmetic (stream
cursors, level offsets, the uniform-bandwidth log hoist, tile sums and the
in-tile scan, for the layouts' tile sizes) draws the twin's labels, and
its points agree to 1e-12: only the order of float64 sums differs."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import kde_tpu  # noqa: E402
from fixtures import gibbs_streams  # noqa: E402
from kde_tpu import manifolds as jm  # noqa: E402
from kde_tpu.reference_impl import serial_gibbs_product  # noqa: E402
from kde_tpu_torch import KDE, manifolds as tm  # noqa: E402
from kde_tpu_torch import kde as tkde  # noqa: E402
from kde_tpu_torch.ops import gibbs as tgibbs  # noqa: E402
from kde_tpu_torch.ops import gibbs_chain as gc  # noqa: E402
from kde_tpu_torch.ops import gibbs_select as gs  # noqa: E402
from kde_tpu_torch.ops import device_plan  # noqa: E402
from kde_tpu_torch.parallel import sizing  # noqa: E402
from kde_tpu_torch.utils.random import counter_uniform  # noqa: E402

F64 = torch.float64
CPU = torch.device("cpu")


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


def _port(jk):
    return KDE(np.asarray(jk.points), np.asarray(jk.bw),
               np.asarray(jk.weights), jk.multibandwidth, dtype=F64)


def _inputs(jsets, n_out, n_iter, masks, seed, streams=None):
    """The port's plans of ``B`` sets of kde_tpu densities, their streams
    (one replay pair a set) and masks, as ``gibbs_chain`` takes them."""
    rng = np.random.default_rng(seed)
    plans = tgibbs._stack_plans([
        tgibbs._get_plan([_port(p) for p in js], n_out, F64, CPU, "host")
        for js in jsets])
    dn, d = len(jsets[0]), jsets[0][0].ndim
    ns = tuple(p.npts for p in jsets[0])
    bu, bn = tgibbs._stream_sizes(dn, d, plans.n_levels, n_iter)
    if streams is None:
        streams = [gibbs_streams(rng, dn, d, n_out, n_iter,
                                 max(ns + (n_out,)))[:2] for _ in jsets]
    u = torch.as_tensor(np.stack([np.asarray(s[0])[:n_out * bu]
                                  .reshape(n_out, bu) for s in streams]))
    nrm = torch.as_tensor(np.stack([np.asarray(s[1])[:n_out * bn]
                                    .reshape(n_out, bn) for s in streams]))
    mask = torch.ones((len(jsets), dn, d), dtype=torch.bool)
    if masks is not None:
        mask = torch.as_tensor(np.asarray(masks, dtype=bool)
                               .reshape(len(jsets), dn, d))
    return u, nrm, plans, mask, streams


# name: (per-set densities maker, n_out, n_iter, hook kinds, mask, entropy)
def _gauss_sets(d, ns, b=1, seed=7, shift=0.0):
    rng = np.random.default_rng(seed)
    return [[kde_tpu.kde(rng.normal(size=(d, n)) + shift * i,
                         list(rng.uniform(0.3, 0.8, size=d))) for n in ns]
            for i in range(b)]


def _circ_sets(b=1, n=32):
    rng = np.random.default_rng(0)
    pts = lambda c: _wrap(c + 0.05 * rng.normal(size=(1, n)))
    return [[kde_tpu.kde(pts(np.pi - 0.2 + 0.3 * i), [0.1]),
             kde_tpu.kde(pts(-np.pi + 0.2 + 0.3 * i), [0.1])]
            for i in range(b)]


def _se2_sets():
    rng = np.random.default_rng(2)
    jh = _hooks(jm, "eec")
    pts = lambda x, y, t: np.vstack([x + 0.15 * rng.normal(size=40),
                                     y + 0.15 * rng.normal(size=40),
                                     _wrap(t + 0.05 * rng.normal(size=40))])
    return [[kde_tpu.kde(pts(2.0, 1.0, np.pi - 0.15), [0.08, 0.08, 0.05],
                         **jh),
             kde_tpu.kde(pts(2.3, 0.8, -np.pi + 0.15), [0.08, 0.08, 0.05],
                         **jh)]]


def _far_sets():
    return [[kde_tpu.kde(np.array([[0.0, 2.0]]), [0.5]),
             kde_tpu.kde(np.array([[100.0, 103.0]]), [0.5])]]


CASES = {
    "d1 n_iter 3": (lambda: _gauss_sets(1, (8, 8)), 8, 3, "e", None, True),
    "d2 dn 3": (lambda: _gauss_sets(2, (16, 16, 16)), 8, 2, "ee", None,
                True),
    "d3 ragged": (lambda: _gauss_sets(3, (10, 33)), 12, 1, "eee", None,
                  True),
    "n_iter 0": (lambda: _gauss_sets(2, (16, 16)), 8, 0, "ee", None, True),
    "dn 3 partial mask": (
        lambda: [[kde_tpu.kde(np.random.default_rng(8).normal(size=(2, 16))
                              + s, [0.4, 0.4]) for s in (5.0, 0.0, -5.0)]],
        8, 2, "ee", [[True, False], [True, True], [False, True]], True),
    "no entropy": (lambda: _gauss_sets(1, (8, 8), seed=9), 4, 3, "e", None,
                   False),
    "dead rows": (_far_sets, 1, 1, "e", None, True),
    "B = 2": (lambda: _gauss_sets(2, (20, 30), b=2, shift=0.4), 10, 2, "ee",
              None, True),
    "circular": (_circ_sets, 16, 3, "c", None, True),
    "circular B = 2": (lambda: _circ_sets(b=2), 12, 2, "c", None, True),
    "se2": (_se2_sets, 12, 2, "eec", None, True),
}


def _case(name, seed=11):
    make, n_out, n_iter, kinds, mask, entropy = CASES[name]
    jsets = make()
    masks = None if mask is None else [mask] * len(jsets)
    u, nrm, plans, m, streams = _inputs(jsets, n_out, n_iter, masks, seed)
    codes = tuple(1 if k == "c" else 0 for k in kinds)
    return jsets, (u, nrm, plans, m, n_iter, entropy, codes), streams, mask


@pytest.mark.parametrize("name", sorted(CASES))
def test_chain_twin_trace_exact_against_kde_tpu(name):
    """Every set of ``gibbs_chain`` on CPU tensors (the twin) equals
    ``kde_tpu.prod_appx_ms_gibbs`` with its streams and hooks and, where
    the hooks are Euclidean, the serial oracle: labels, per-level labels
    and points."""
    jsets, args, streams, mask = _case(name)
    u, nrm, plans, m, n_iter, entropy, codes = args
    n_out = nrm.shape[1]
    pts, idx, labels = gc.gibbs_chain(*args)
    assert pts.shape == (len(jsets), n_out, m.shape[2])
    assert labels.shape == (len(jsets), n_out, plans.n_levels, m.shape[1])
    kinds = CASES[name][3]
    jhooks = _hooks(jm, kinds) if "c" in kinds else {}
    kw = dict(add_entropy=entropy, partial_dim_mask=mask)
    for i, js in enumerate(jsets):
        refs = [kde_tpu.prod_appx_ms_gibbs(
            n_out, js, n_iter=n_iter, rand_u=streams[i][0],
            rand_n=streams[i][1], record_labels=True, **kw, **jhooks)]
        if not jhooks:
            refs.append(serial_gibbs_product(
                [p.tree for p in js], n_out, n_iter, streams[i][0],
                streams[i][1], **kw))
        for pr, ir, lr in refs:
            np.testing.assert_array_equal(idx[i].numpy().T, np.asarray(ir))
            np.testing.assert_array_equal(
                labels[i].numpy().transpose(0, 2, 1), np.asarray(lr))
            np.testing.assert_allclose(pts[i].numpy().T, np.asarray(pr),
                                       rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("entropy", [True, False])
def test_chain_twin_worked_trace(entropy):
    """The hand-checked trace of tests/test_worked_trace.py (two 1-D
    two-kernel densities, one chain, n_iter 1)."""
    u_s = np.array([0.77, 0.43, 0.20, 0.81, 0.65, 0.07, 0.55, 0.93, 0.31,
                    0.48])
    n_s = np.array([0.6, -1.1, 0.35])
    jsets = [[kde_tpu.kde(np.array([[0.0, 2.0]]), [0.5]),
              kde_tpu.kde(np.array([[1.0, 3.0]]), [1.0])]]
    u, nrm, plans, m, _ = _inputs(jsets, 1, 1, None, 0, [(u_s, n_s)])
    pts, idx, _ = gc.gibbs_chain(u, nrm, plans, m, 1, entropy, (0,))
    ps, is_, _ = serial_gibbs_product([p.tree for p in jsets[0]], 1, 1, u_s,
                                      n_s, add_entropy=entropy)
    np.testing.assert_array_equal(idx[0].numpy().T, is_)
    np.testing.assert_allclose(pts[0].numpy().T, ps, rtol=1e-12)


# ---- a NumPy emulation of csrc/gibbs_chain.cu's per-chain arithmetic -------

def _dn_sum(terms, fastest):
    """A sum over the densities in the kernel's order (torch's CUDA
    reduction order, chip_smoke.dn_sum): off the fastest-striding dim,
    four accumulators then ((a0 + a1) + a2) + a3; on it, last_pow2(dn)
    lanes of at most two terms, then a tree at offsets lanes / 2, ..., 1."""
    dn = len(terms)
    if not fastest:
        acc = [0.0] * 4
        for j in range(dn):
            acc[j % 4] = acc[j % 4] + terms[j]
        return ((acc[0] + acc[1]) + acc[2]) + acc[3]
    lanes = 1 << (dn.bit_length() - 1)
    v = [(0.0 + terms[t]) + (0.0 + terms[t + lanes] if t + lanes < dn
                             else 0.0) for t in range(lanes)]
    o = lanes // 2
    while o:
        for t in range(o):
            v[t] = v[t] + v[t + o]
        o //= 2
    return v[0]


def _emulate(u, nrm, plans, mask, n_iter, add_entropy, codes, group,
             mode="cdf", seeds=None):
    """The kernel's steps for every chain, in float64 NumPy: the roots, the
    stream cursors (uniforms ``dn + l (1 + n_iter) dn + ...``, normals
    ``l d + k``), the level offsets, the product over densities in the
    card's summation order with the circular anchor at the first max, the log of ``c`` once
    where the level's bandwidth is uniform, and the draw: for cdf the tile
    sums of a layout of ``group`` threads, the tile scan against ``u *
    sum`` and the scan in the tile; for gumbel one pass of argmaxes on the
    counter noise of (seed, chain, selection id = the uniform cursor), the
    sum of exps for the dead test taken only where the max is below
    log(1e-99).  Returns points, per-level labels and the hoisted share of
    (selection, dim) pairs."""
    u = None if u is None else u.numpy()
    nrm = nrm.numpy()
    tmn, tbw = plans.t_mean.numpy(), plans.t_bw.numpy()
    lm, lb = plans.lvl_mean.numpy(), plans.lvl_bw.numpy()
    lw, lp = plans.lvl_logw.numpy(), plans.lvl_perm.numpy()
    uni = plans.lvl_uniform.numpy().astype(bool)
    mask = mask.numpy()
    b_n, c_n = nrm.shape[:2]
    dn, d = mask.shape[1:]
    L = plans.n_levels
    tp, inv = 2 * math.pi, 1 / (2 * math.pi)
    cdiff = lambda a, r: (a - r) - tp * np.rint((a - r) * inv)
    cadd = lambda a, s: (a + s) - tp * np.rint((a + s) * inv)
    hooked = any(codes)
    xs = np.zeros((b_n, c_n, d))
    labels = np.zeros((b_n, c_n, L, dn), dtype=np.int64)
    hoisted = [0, 0]
    for b in range(b_n):
        mk = mask[b]
        act = mk & ((mk.sum(axis=0)[None] - mk) > 0)
        for c in range(c_n):
            mu_sel = np.where(mk, tmn[b, :, 0], 0.0)
            var_sel = np.where(mk, tbw[b, :, 0], 0.0)
            perms = np.zeros(dn, dtype=np.int64)
            U, N = None if u is None else u[b, c], nrm[b, c]

            def product(skip):
                m, cv = np.zeros(d), np.zeros(d)
                for k in range(d):
                    con = mk[:, k] & (np.arange(dn) != skip)
                    v = var_sel[:, k]
                    lam = np.where(con & (v > 0),
                                   1.0 / np.where(v > 0, v, 1.0), 0.0)
                    lt = _dn_sum(lam, hooked or d == 1)
                    cov = 1.0 / lt if con.any() else 0.0
                    if codes[k] == 0:
                        m[k] = cov * _dn_sum(lam * mu_sel[:, k],
                                             hooked or d == 1)
                    elif con.any():
                        ref = mu_sel[int(np.argmax(lam)), k]
                        m[k] = cadd(ref, cov * _dn_sum(
                            cdiff(mu_sel[:, k], ref) * lam, hooked))
                    cv[k] = cov
                return m, cv

            def sample(nv, jitter):
                m, cv = product(-1)
                if not jitter:
                    return m
                step = np.sqrt(cv) * nv
                return np.array([cadd(m[k], step[k]) if codes[k]
                                 else m[k] + step[k] for k in range(d)])

            def select(j, l, q, cq, col):
                o, w = plans.offsets[l]
                mean, bw = lm[b, j, o:o + w], lb[b, j, o:o + w]
                logw = lw[b, j, o:o + w]
                acc = np.zeros(w)
                for k in range(d):
                    if not act[j, k]:
                        continue
                    hoisted[1] += 1
                    if uni[b, j, l, k]:
                        hoisted[0] += 1
                        c0 = bw[0, k] if cq is None else bw[0, k] + cq[k]
                        cvals, lcv = np.full(w, c0), np.full(w, np.log(c0))
                    else:
                        cvals = bw[:, k] if cq is None else bw[:, k] + cq[k]
                        lcv = np.log(cvals)
                    dl = (cdiff(mean[:, k], q[k]) if codes[k]
                          else mean[:, k] - q[k])
                    pd = dl * dl / cvals + lcv
                    acc = acc + np.where(np.isnan(pd), 0.0, pd)
                lv = logw - 0.5 * acc
                lv = np.where(np.isnan(lv), -np.inf, lv)
                ms = 0.0 if lv.max() == -np.inf else lv.max()
                if mode == "gumbel":
                    g = counter_uniform(seeds[b:b + 1], torch.tensor([c]),
                                        torch.tensor([col]), w,
                                        F64)[0, 0, 0].numpy()
                    gn = np.log(-np.log(g))
                    dead = (not lv.max() >= gs.LOG_DEAD
                            and ms + np.log(np.exp(lv - ms).sum())
                            < gs.LOG_DEAD)
                    if dead:
                        return int(np.argmax(np.where(logw != -np.inf, -gn,
                                                      -np.inf)))
                    return int(np.argmax(lv - gn))
                uval = U[col]
                e = np.exp(lv - ms)
                if ms + np.log(e.sum()) < gs.LOG_DEAD:
                    e = (logw != -np.inf).astype(np.float64)
                tile = group * -(-(-(-w // 64)) // group)
                sums = [e[t:t + tile].sum() for t in range(0, w, tile)]
                target = uval * sum(sums)
                off = 0.0
                for tau, s in enumerate(sums):
                    if not off + s < target:
                        cum = off + np.cumsum(e[tau * tile:(tau + 1) * tile])
                        hits = np.nonzero(~(cum < target))[0]
                        last = min((tau + 1) * tile, w) - 1
                        return tau * tile + hits[0] if hits.size else last
                    off = off + s
                return w - 1

            def pick(j, l, z):
                o = plans.offsets[l][0]
                mu_sel[j] = np.where(mk[j], lm[b, j, o + z], 0.0)
                var_sel[j] = np.where(mk[j], lb[b, j, o + z], 0.0)
                perms[j] = lp[b, j, o + z]

            per = (1 + n_iter) * dn
            for l in range(L):
                x = sample(N[l * d:(l + 1) * d], True)
                for j in range(dn):
                    pick(j, l, select(j, l, x, None, dn + l * per + j))
                for it in range(n_iter):
                    for j in range(dn):
                        mu, cov = product(j)
                        pick(j, l, select(j, l, mu, cov,
                                          dn + l * per + dn + it * dn + j))
                labels[b, c, l] = perms
            xs[b, c] = sample(N[L * d:(L + 1) * d], add_entropy)
    return xs, labels, hoisted[0] / max(hoisted[1], 1)


# the tile partitions of the layouts: 32 threads (the warp layout, and the
# staged layout, whose lanes take a warp's candidates and tiles) and
# CTA_THREADS (the block layout)
@pytest.mark.parametrize("group", [32, gc.CTA_THREADS])
@pytest.mark.parametrize("name", ["d2 dn 3", "dn 3 partial mask",
                                  "dead rows", "B = 2", "circular B = 2",
                                  "se2", "n_iter 0"])
def test_kernel_emulation_draws_the_twins_labels(name, group):
    """The kernel's arithmetic, emulated in NumPy, against the twin:
    labels equal at every level, points to 1e-12."""
    _, args, _, _ = _case(name)
    pts, _, labels = gc.gibbs_chain_ref(*args)
    x, lab, _ = _emulate(*args, group)
    np.testing.assert_array_equal(lab, labels.numpy())
    np.testing.assert_allclose(x, pts.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["d2 dn 3", "dn 3 partial mask",
                                  "dead rows", "B = 2", "circular B = 2",
                                  "se2", "n_iter 0", "no entropy"])
def test_kernel_emulation_draws_the_twins_gumbel_labels(name):
    """Gumbel: the kernel's one-pass draw (argmaxes on the counter noise of
    seed, chain and selection id, the dead test only below log(1e-99)),
    emulated in NumPy, against the twin (the eager chain with the twin's
    counter noise): labels equal at every level, points to 1e-12."""
    _, args, _, _ = _case(name)
    u, nrm, plans, m, n_iter, entropy, codes = args
    seeds = torch.tensor([[11, 0x12345678 + i] for i in range(nrm.shape[0])])
    gargs = (None, nrm, plans, m, n_iter, entropy, codes, "gumbel", seeds)
    pts, _, labels = gc.gibbs_chain(*gargs)
    x, lab, _ = _emulate(*gargs[:7], 32, "gumbel", seeds)
    np.testing.assert_array_equal(lab, labels.numpy())
    np.testing.assert_allclose(x, pts.numpy(), rtol=1e-12, atol=1e-12)
    assert not torch.equal(labels, gc.gibbs_chain(*gargs[:8], seeds + 1)[2])


@pytest.mark.parametrize("group", [32, gc.CTA_THREADS])
def test_kernel_emulation_wide_levels_and_mixed_bandwidths(group):
    """Levels wide enough for many tiles (600 components: the leaf splits
    into 19 / 2 tiles of 32 / 512 candidates), one density with a
    bandwidth a kernel (no hoist) and one uniform (hoisted at every
    level), B = 2: labels equal, points to 1e-12, and both kinds of
    dims present."""
    rng = np.random.default_rng(31)
    jsets = [[kde_tpu.kde(rng.normal(size=(2, 600)) + 0.3 * i, [0.3, 0.2]),
              kde_tpu.kde(rng.normal(size=(2, 600)) + 0.5,
                          rng.uniform(0.1, 0.4, size=(2, 600)) ** 2)]
             for i in range(2)]
    u, nrm, plans, m, _ = _inputs(jsets, 6, 2, None, 5)
    args = (u, nrm, plans, m, 2, True, (0, 0))
    pts, _, labels = gc.gibbs_chain_ref(*args)
    x, lab, share = _emulate(*args, group)
    np.testing.assert_array_equal(lab, labels.numpy())
    np.testing.assert_allclose(x, pts.numpy(), rtol=1e-12, atol=1e-12)
    assert 0.0 < share < 1.0
    assert max(w for _, w in plans.offsets) == 600


# ---- hooks, plans, routes and the wrapper -----------------------------------

def test_hook_codes_and_their_inverse():
    """0 per Euclidean quadruple, 1 per circular one, None for anything
    else (a lone circular diffop, a user's callable); SE(2) is (0, 0, 1)."""
    norm = lambda kinds: tgibbs.normalize_hooks(*_hooks(tm, kinds).values(),
                                                len(kinds))
    assert gc.hook_codes(tgibbs._NO_HOOKS, 3) == (0, 0, 0)
    assert gc.hook_codes(norm("eec"), 3) == (0, 0, 1)
    assert gc.hook_codes(norm("c"), 1) == (1,)
    lone = tgibbs.normalize_hooks(None, (tm.circular_diff,), None, None, 1)
    assert gc.hook_codes(lone, 1) is None
    user = tgibbs.normalize_hooks(None, (lambda a, b: a - b,), None, None, 2)
    assert gc.hook_codes(user, 2) is None
    for kinds in ("e", "c", "eec", "cec"):
        codes = tuple(int(k == "c") for k in kinds)
        assert gc.hook_codes(gc.hooks_of(codes), len(kinds)) == codes
    assert gc.hooks_of((0, 0)) == tgibbs._NO_HOOKS
    assert gc.hooks_of((0, 1)) == norm("ec")


@pytest.mark.parametrize("select,kinds,device,want", [
    ("cdf", "ee", "cuda", "chain"), ("cdf", "eec", "cuda", "chain"),
    ("cdf", "c", "cuda", "chain"), ("cdf", "lone", "cuda", "kernel"),
    ("cdf", "user", "cuda", "twin"), ("gumbel", "ee", "cuda", "chain"),
    ("gumbel", "c", "cuda", "chain"), ("gumbel", "lone", "cuda", "kernel"),
    ("blocked", "ee", "cuda", "twin"), ("cdf", "ee", "cpu", "twin"),
    ("gumbel", "c", "cpu", "twin")])
def test_route_per_select_hooks_and_device(select, kinds, device, want):
    """``_route`` reads only the device's type, the selection and the
    hooks: the chain kernel for cdf and gumbel with Euclidean or circular
    quadruples on the card, gibbs_select for a circular diffop alone, the
    eager twin for blocked, a user's callable and the CPU."""
    if kinds == "lone":
        hooks = tgibbs.normalize_hooks(None, (tm.circular_diff,), None, None,
                                       2)
    elif kinds == "user":
        hooks = tgibbs.normalize_hooks(None, (lambda a, b: a - b,), None,
                                       None, 2)
    else:
        hooks = tgibbs.normalize_hooks(*_hooks(tm, kinds).values(),
                                       len(kinds))
    d = 2 if kinds in ("lone", "user") else len(kinds)
    assert tgibbs._route(select, hooks, device, 2, d) == want


def test_route_leaves_the_chain_kernel_beyond_its_limits():
    """More densities or dims than the chain kernel's state holds take the
    selection kernel instead, cdf and gumbel alike."""
    for select in ("cdf", "gumbel"):
        assert tgibbs._route(select, None, "cuda", gc.MAX_DENS,
                             gc.MAX_DIM) == "chain"
        assert tgibbs._route(select, None, "cuda", gc.MAX_DENS + 1,
                             2) == "kernel"
        assert tgibbs._route(select, None, "cuda", 2,
                             gc.MAX_DIM + 1) == "kernel"


def test_chain_route_is_one_call_for_every_chain(monkeypatch):
    """On the chain route ``_gibbs_all_chains`` makes one ``gibbs_chain``
    call for all chains of all sets, whatever the block budget, and draws
    the product the stage route draws."""
    _, args, _, _ = _case("B = 2")
    u, nrm, plans, mask, n_iter, entropy, codes = args
    want = tgibbs._gibbs_all_chains(u, nrm, plans, mask, n_iter, entropy)
    calls = []

    def spy(*a):
        calls.append(a[1].shape)
        return gc.gibbs_chain_ref(*a)
    monkeypatch.setattr(tgibbs, "_route", lambda *a: "chain")
    monkeypatch.setattr(tgibbs, "CHAIN_BLOCK_BYTES", 1)
    monkeypatch.setattr(gc, "gibbs_chain", spy)
    got = tgibbs._gibbs_all_chains(u, nrm, plans, mask, n_iter, entropy)
    assert calls == [nrm.shape]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_sizing_on_the_chain_route(monkeypatch):
    """The sizing estimate follows the route: on the chain route the
    temporaries are the streams alone (each set's draw and their stacked
    copy), all chains one block."""
    rng = np.random.default_rng(3)
    dens = [_port(kde_tpu.kde(rng.normal(size=(2, 300)), [0.3]))
            for _ in range(2)]
    n_out = 500
    monkeypatch.setattr(tgibbs, "_route", lambda *a: "chain")
    est = sizing.estimate_product_memory(dens, n_out, dtype=F64,
                                         select="cdf")
    plan = tgibbs._get_plan(dens, n_out, F64, CPU)
    bu, bn = tgibbs._stream_sizes(2, 2, plan.n_levels, 5)
    assert est["temp"] == 2 * n_out * (bu + bn) * 8
    monkeypatch.setattr(tgibbs, "_route", lambda *a: "twin")
    twin = sizing.estimate_product_memory(dens, n_out, dtype=F64,
                                          select="cdf")
    assert twin["temp"] > est["temp"]
    # device-resident copies take the device plan: its topology cache and
    # build workspace count as arguments
    copies = [KDE(k.points, k.bw, k.weights) for k in dens]
    dev = sizing.estimate_product_memory(copies, n_out, dtype=F64,
                                         select="cdf")
    plan = tgibbs._get_plan(copies, n_out, F64, CPU, "device")
    assert dev["args"] == (sum(getattr(plan, f).nbytes
                               for f in tgibbs._PLAN_TENSORS) + 4
                           + plan.lvl_uniform.nbytes
                           + device_plan.build_bytes(
                               (300, 300), 2, 8, plan.lvl_logw.numel()))


def test_plans_carry_the_uniform_flags():
    """The host plan, the device-built plan and the batched plans carry
    ``lvl_uniform`` equal to ``level_uniform`` of their bandwidths; a
    uniform-bandwidth density's leaf is uniform, a multi-bandwidth one's
    is not."""
    from kde_tpu_torch.ops import device_plan
    rng = np.random.default_rng(4)
    one = tkde(rng.normal(size=(2, 100)), [0.3], dtype=F64)
    multi = tkde(rng.normal(size=(2, 100)),
                 rng.uniform(0.1, 0.3, size=(2, 100)), dtype=F64)
    host = tgibbs._get_plan([one, multi], 100, F64, CPU, "host")
    dev = device_plan.DeviceProductPlan([one, multi], 100, F64)
    batched = tgibbs._SetPlans(*device_plan.batched_device_plans(
        [[one, multi]] * 2, 100, F64))
    for p, bw in ((host, host.lvl_bw), (dev, dev.lvl_bw),
                  (batched, batched.lvl_bw)):
        flags = p.lvl_uniform
        assert torch.equal(flags, gc.level_uniform(bw, p.offsets))
        assert flags.dtype == torch.uint8
        leaf = flags[..., -1, :].reshape(-1, 2, 2)
        assert bool(leaf[:, 0].all()) and not bool(leaf[:, 1].any())
    stacked = tgibbs._stack_plans([host])
    assert torch.equal(stacked.lvl_uniform[0], host.lvl_uniform)


def test_level_uniform_ignores_padding():
    """Padded slots repeat a real node, so the ragged leaf of a uniform
    7-point density, padded to the 30-point density's width, stays
    uniform (its upper levels, moment-matched clusters, are not)."""
    rng = np.random.default_rng(5)
    dens = [tkde(rng.normal(size=(1, n)), [0.2], dtype=F64) for n in (7, 30)]
    plan = tgibbs._get_plan(dens, 30, F64, CPU, "host")
    o, w = plan.offsets[-1]
    assert bool((plan.lvl_logw[0, o:o + w] == -math.inf).any())
    assert bool(plan.lvl_uniform[:, -1].all())
    assert not bool(plan.lvl_uniform[:, 0].all())


def _small():
    _, args, _, _ = _case("d2 dn 3")
    return args


def test_wrapper_refuses_bad_inputs():
    """Wrong stream shapes, a missing u (cdf) or seeds (gumbel), u with
    gumbel, seeds of the wrong shape or type, another selection, codes of
    the wrong length or None, a float16 stream, a non-bool mask and mixed
    devices raise; the CPU call counts no launch."""
    u, nrm, plans, mask, n_iter, entropy, codes = _small()
    before = gc.LAUNCHES
    gc.gibbs_chain(u, nrm, plans, mask, n_iter, entropy, codes)
    assert gc.LAUNCHES == before
    with pytest.raises(ValueError, match="level"):
        gc.gibbs_chain(u[:, :, 1:], nrm, plans, mask, n_iter, entropy, codes)
    with pytest.raises(ValueError, match="level"):
        gc.gibbs_chain(u, nrm, plans, mask, n_iter + 1, entropy, codes)
    with pytest.raises(ValueError, match="from the uniform"):
        gc.gibbs_chain(None, nrm, plans, mask, n_iter, entropy, codes)
    seeds = torch.zeros((nrm.shape[0], 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="takes no u"):
        gc.gibbs_chain(u, nrm, plans, mask, n_iter, entropy, codes,
                       "gumbel", seeds)
    with pytest.raises(ValueError, match="seeds"):
        gc.gibbs_chain(None, nrm, plans, mask, n_iter, entropy, codes,
                       "gumbel", seeds[:, :1])
    with pytest.raises(TypeError, match="int64 lvl_perm and seeds"):
        gc.gibbs_chain(None, nrm, plans, mask, n_iter, entropy, codes,
                       "gumbel", seeds.int())
    with pytest.raises(ValueError, match="cdf or gumbel"):
        gc.gibbs_chain(u, nrm, plans, mask, n_iter, entropy, codes,
                       "blocked")
    for bad in (None, (0,), (0, 2)):
        with pytest.raises(ValueError, match="codes"):
            gc.gibbs_chain(u, nrm, plans, mask, n_iter, entropy, bad)
    with pytest.raises(TypeError, match="float32 or float64"):
        gc.gibbs_chain(u.half(), nrm, plans, mask, n_iter, entropy, codes)
    with pytest.raises(TypeError, match="bool mask"):
        gc.gibbs_chain(u, nrm, plans, mask.to(torch.uint8), n_iter, entropy,
                       codes)
    with pytest.raises(ValueError, match="one CUDA device"):
        gc.gibbs_chain(u, nrm.to("meta"), plans, mask, n_iter, entropy,
                       codes)


def test_wrapper_refuses_more_dims_than_the_kernel_holds():
    rng = np.random.default_rng(6)
    d = gc.MAX_DIM + 1
    jsets = [[kde_tpu.kde(rng.normal(size=(d, 8)), [0.5]) for _ in range(2)]]
    u, nrm, plans, mask, _ = _inputs(jsets, 4, 1, None, 0)
    with pytest.raises(ValueError, match="at most"):
        gc.gibbs_chain(u, nrm, plans, mask, 1, True, (0,) * d)


def test_launch_plan_reads_the_set_shape():
    """Float32 at d <= 3 with STAGED_MIN_CHAINS chains and more over levels
    of STAGED_MIN_WIDTH and more (the slice, the batched product), a
    multiple of the staged layout's chains a block or not: the staged
    layout; narrow levels (the headline, ``scaling_bench``) at any chain
    count, fewer chains over wide levels (serve), float64 and d = 4 keep
    the warp layout for many chains or narrow levels and a block a chain
    for few chains over wide levels."""
    assert gc.launch_plan(20_000, 20_000) == "staged"
    assert gc.launch_plan(20_001, 20_000, torch.float32, 1) == "staged"
    assert gc.launch_plan(1024, 10_000, torch.float32, 3) == "staged"
    assert gc.launch_plan(gc.STAGED_MIN_CHAINS, gc.STAGED_MIN_WIDTH) == \
        "staged"
    assert gc.launch_plan(1001, 50_000) == "block"
    assert gc.launch_plan(4096, 1000) == "warp"
    assert gc.launch_plan(1000, 1000) == "warp"
    assert gc.launch_plan(20_000, gc.STAGED_MIN_WIDTH - 1) == "warp"
    assert gc.launch_plan(256, 50_000) == "block"
    assert gc.launch_plan(gc.STAGED_MIN_CHAINS - 1, 50_000) == "block"
    for dt, d in ((F64, 2), (torch.float32, 4)):
        assert gc.launch_plan(20_000, 20_000, dt, d) == "warp"
        assert gc.launch_plan(1000, 1000, dt, d) == "warp"
        assert gc.launch_plan(256, 50_000, dt, d) == "block"
        assert gc.launch_plan(gc.WARP_MIN_CHAINS - 1, gc.WARP_MAX_WIDTH + 1,
                              dt, d) == "block"
