"""The sharded LOOCV search's launches (``kde_tpu_torch/ops/sharded_loo.py``,
K7's plain twins on the CPU) against float64 NumPy, over a split of the
queries into rank shards with every column on each rank and the diagonal
at each shard's offset, the sweep plan's grid, and the twin search against
the single-device search ``loo_search_ref``.

No process group: the psum is composed by hand (the ranks' entropies
summed) or, in ``search``, is the identity of one rank.  The data has
non-uniform weights, zero-weight padding and, in one case, a query with no
live neighbour at all (its objective +inf)."""
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_cpu import on_cpu  # noqa: E402,F401

from kde_tpu_torch.ops import loo_search, loocv  # noqa: E402
from kde_tpu_torch.ops import sharded_loo as sl  # noqa: E402

N, D, PAD = 37, 2, 3            # 40 rows: 4 query shards of 10
TOL = 1e-2


def _data(lonely=False):
    """Points [N + PAD, D], weights summing to 1 over the first N (the
    padding weighs 0); of rows 0..19 only row 5 is live.  ``lonely``: row
    5 is the only live point (weight 0.5, as a launch may be given it)."""
    rng = np.random.default_rng(16)
    pts = np.zeros((N + PAD, D))
    pts[:N] = rng.normal(size=(N, D)) * [1.0, 2.5]
    w = np.zeros(N + PAD)
    w[:N] = rng.uniform(0.5, 1.5, size=N)
    w[:20] = 0.0
    w[5] = 1.0
    w /= w.sum()
    if lonely:
        w[:] = 0.0
        w[5] = 0.5
    return pts, w


def _bracket(pts, dtype):
    rows = torch.as_tensor(pts[:N].T.copy(), dtype=dtype)
    return loocv.bracket_rows(rows, *loocv._slices_on(N, rows.device))


def _np_nn(pts, w, rows, cols):
    """[D, |rows|]: least squared distance from each query to a live
    column other than itself (+inf where none)."""
    out = np.full((D, len(rows)), np.inf)
    for a, i in enumerate(rows):
        for j in cols:
            if w[j] > 0 and j != i:
                out[:, a] = np.minimum(out[:, a], (pts[i] - pts[j]) ** 2)
    return out


def _np_sums(pts, w, rows, cols, shift, var):
    """[R, |rows|]: sum_{j != i, live} w_j exp(-(d2 - shift) / (2 var)),
    row r of dimension r % D with variance var[r]."""
    R = len(var)
    out = np.zeros((R, len(rows)))
    for r in range(R):
        k = r % D
        for a, i in enumerate(rows):
            s = shift[k, a] if np.isfinite(shift[k, a]) else 0.0
            for j in cols:
                if w[j] > 0 and j != i:
                    d2 = (pts[i, k] - pts[j, k]) ** 2
                    out[r, a] += w[j] * np.exp(-(d2 - s) / (2 * var[r]))
    return out


def _np_entropy(sums, shift, qw, var):
    R = len(var)
    out = np.zeros((R, 2))
    with np.errstate(divide="ignore"):
        for r in range(R):
            k = r % D
            s = np.where(np.isfinite(shift[k]), shift[k], 0.0)
            logp = (np.log(sums[r]) - s / (2 * var[r])
                    - 0.5 * np.log(var[r]) - 0.5 * np.log(2 * np.pi)
                    - np.log1p(-qw))
            pos = qw > 0
            out[r, 0] = -np.sum(qw[pos] * logp[pos])
            out[r, 1] = np.sum(np.isneginf(logp) & pos)
    return out


def _shards(n_rows, n_shards):
    step = n_rows // n_shards
    return [range(s * step, (s + 1) * step) for s in range(n_shards)]


def _t(x, dtype):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)


QUERY_SHARDS = 4                # the 40 rows over a 4-rank mesh


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stage_and_nn_shift_against_numpy(dtype):
    """Staging every column (+inf where w = 0, whole tiles) and the golden
    state of sweep 0 in buffer 0; each query shard's nearest live
    neighbours over all the columns, with the diagonal at the shard's
    offset, concatenated equal NumPy's whole problem (the squared
    differences round alike); the lonely point 5 has none (+inf)."""
    pts, w = _data(lonely=True)
    base, ax, bx, cx = _bracket(pts, dtype)
    n = N + PAD
    xs, wp, st, fl = sl.stage(_t(pts, dtype), _t(w, dtype), ax, bx, cx)
    assert xs.shape == (D, sl.TILE) and wp.shape == (sl.TILE,)
    assert st.shape == (2, 8, D) and fl.shape == (2, D)
    np.testing.assert_array_equal(
        xs[:, :n].numpy(), np.where(w[None, :] > 0, pts.T.astype(
            xs.numpy().dtype), np.inf))
    assert torch.isinf(xs[:, n:]).all()
    assert (wp[n:] == 0).all() and fl[0].tolist() == [2] * D
    pts_r = pts.astype(xs.numpy().dtype).astype(np.float64)
    for lonely in (True, False):
        pts, w = _data(lonely)
        xs, wp, _, _ = sl.stage(_t(pts, dtype), _t(w, dtype), ax, bx, cx)
        got = torch.cat([sl.nn_shift(_t(pts[r.start:r.stop], dtype), xs, wp,
                                     r.start)
                         for r in _shards(n, QUERY_SHARDS)], dim=1)
        want = _np_nn(pts_r, w, range(n), range(n))
        np.testing.assert_allclose(got.double().numpy(), want,
                                   rtol=1e-6 if dtype == torch.float32
                                   else 0)
        assert math.isinf(float(got[0, 5])) == lonely
        torch.testing.assert_close(got, sl.nn_shift(_t(pts, dtype), xs, wp),
                                   rtol=0, atol=0)
    # the golden state of sweep 0, as _golden_core places x1 and x2
    wide = (cx - bx).abs() > (bx - ax).abs()
    torch.testing.assert_close(st[0, sl.PR0], torch.where(
        wide, bx, bx - loo_search._C * (bx - ax)), rtol=0, atol=0)
    torch.testing.assert_close(st[0, sl.PR1], torch.where(
        wide, bx + loo_search._C * (cx - bx), bx), rtol=0, atol=0)


def _sweep_shards(pts, w, dtype, bracket, shards=QUERY_SHARDS):
    """Every rank's Sweeps over its query shard, all columns staged once
    (each rank its own copy of the state)."""
    base, ax, bx, cx = bracket
    m, mw = _t(pts, dtype), _t(w, dtype)
    out = []
    for r in _shards(len(pts), shards):
        xs, wp, st, fl = sl.stage(m, mw, ax, bx, cx)
        q = m[r.start:r.stop]
        out.append(sl.sweeps(q, mw[r.start:r.stop], xs, wp,
                             sl.nn_shift(q, xs, wp, r.start), base, st, fl,
                             q0=r.start, tol=TOL))
    return out


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-5)])
@pytest.mark.parametrize("lonely", [False, True])
def test_sweep_over_4_query_shards(dtype, rtol, lonely):
    """Sweeps 0 and 1 (x1 and x2 of both dimensions, then one probe a
    dimension) over a 4-rank query split with every column on each rank:
    the ranks' (h, bad), summed as the psum sums them, equal NumPy's whole
    problem (non-uniform weights, zero-weight padding); sweep 1's head,
    the golden step of sweep 0 from the summed entropies, is the same on
    every rank.  ``lonely``: query 5 has no live neighbour at all, so its
    sum is 0, log p -inf and every row's objective +inf, with no NaN."""
    pts, w = _data(lonely)
    bracket = _bracket(pts, dtype)
    base = bracket[0]
    ranks = _sweep_shards(pts, w, dtype, bracket)
    pts_r = pts.astype(_t(pts, dtype).numpy().dtype).astype(np.float64)
    shift = _np_nn(pts_r, w, range(len(pts)), range(len(pts)))
    for s in (0, 1):
        for sw in ranks:
            sl.sweep(sw, s)
        total = sum(sw.ent_v[s] for sw in ranks)
        for sw in ranks:                     # the psum, in place
            sw.ent_v[s].copy_(total)
        assert len({tuple(sw.flag_v[s].tolist()) for sw in ranks}) == 1
        st = ranks[0].st[s & 1]
        if s == 0:
            x = torch.cat([st[sl.PR0], st[sl.PR1]])
        else:
            for sw in ranks[1:]:
                assert torch.equal(sw.st[1], ranks[0].st[1])
                assert torch.equal(sw.fl[1], ranks[0].fl[1])
            x = st[sl.PR0]
        rows = sl.n_rows(s, D)
        var = ((x ** 2) * base.repeat(rows // D) ** 2).double().numpy()
        sums = _np_sums(pts_r, w, range(len(pts)), range(len(pts)), shift,
                        var)
        want = _np_entropy(sums, shift, w, var)
        on = (np.ones(rows, bool) if s == 0
              else ((ranks[0].fl[1] & 2) != 0).numpy())
        assert not torch.isnan(total).any()
        if lonely:
            assert (total[on, 1] == 1).all() and (want[on, 1] == 1).all()
            assert sums[0, 5] == 0.0
        else:
            assert (total[:, 1] == 0).all()
            np.testing.assert_allclose(total[on, 0].numpy(), want[on, 0],
                                       rtol=rtol)
        assert (total[~on] == 0).all()
    f = ranks[0].st[1][sl.F1:sl.F2 + 1]
    assert torch.isinf(f).all() if lonely else torch.isfinite(f).all()


@pytest.mark.parametrize("mq,n_pad,rows,sms", [
    (8192, 8192, 4, 132), (2048, 8192, 2, 132), (40, 1024, 4, 132),
    (750, 3072, 4, 132), (25000, 100352, 2, 132), (100, 9216, 2, 16),
    (64, 10240, 2, 132)])
def test_sweep_plan_covers_every_pair_once(mq, n_pad, rows, sms):
    """The grid of sweep_plan, decoded block by block as the kernel decodes
    it: every (row, query, column tile) triple exactly once, no empty
    chunk; one chunk where a block a (row, group) gives two blocks an SM,
    else at least two an SM where the tiles allow."""
    plan = sl.sweep_plan(mq, n_pad, rows, sms)
    blocks = plan.rows * plan.groups * plan.chunks
    n_tiles = n_pad // sl.TILE
    seen = np.zeros((rows, mq, n_tiles), np.int64)
    for b in range(blocks):
        row, (qa, qb), (ca, cb) = sl.plan_block(plan, b, mq, n_pad)
        assert qa < qb and ca < cb and ca % sl.TILE == 0
        seen[row, qa:qb, ca // sl.TILE:-(-cb // sl.TILE)] += 1
    assert (seen == 1).all()
    assert plan.chunks == -(-n_tiles // plan.tiles)
    assert blocks >= min(2 * sms, rows * plan.groups * n_tiles)
    if rows * plan.groups >= 2 * sms:
        assert plan.chunks == 1


def _golden_np(st, fl, f, sweep, tol, n_iters, d):
    """NumPy float64 of _golden_core's step after sweep ``sweep``, and the
    active test of the step after it on the new bracket."""
    x0, x1, x2, x3, f1, f2, pr0, _ = (st[r].copy() for r in range(8))
    if sweep == 0:
        f1, f2 = f[:d], f[d:]
    else:
        was, t2 = (fl & 2) != 0, (fl & 1) != 0
        f1, f2 = (np.where(was & t2, f2, np.where(was, f, f1)),
                  np.where(was & t2, f, np.where(was, f1, f2)))
    active = np.abs(x3 - x0) > tol * (np.abs(x1) + np.abs(x2))
    active &= sweep < n_iters
    take2 = (f2 < f1) & active
    take1 = ~take2 & active
    _C, _R = loo_search._C, loo_search._R
    nx2 = np.where(take2, _R * x2 + _C * x3, np.where(take1, x1, x2))
    nx1 = np.where(take2, x2, np.where(take1, _R * x1 + _C * x0, x1))
    nx0 = np.where(take2, x1, x0)
    nx3 = np.where(take1, x2, x3)
    probe = np.where(take2, nx2, np.where(active, nx1, pr0))
    nxt = (np.abs(nx3 - nx0) > tol * (np.abs(nx1) + np.abs(nx2))) & (
        sweep + 1 < n_iters)
    return (np.stack([nx0, nx1, nx2, nx3, f1, f2, probe]),
            take2.astype(int) | (active.astype(int) << 1), nxt)


@pytest.mark.parametrize("sweep", [0, 1, 7, 200])
def test_golden_step_against_numpy(sweep):
    """The masked update of _golden_core from a state with one frozen row
    (bit 1 of fl clear), one taking x2 and one taking x1, from buffer
    ``sweep & 1`` into the other; the flag is the next step's active test
    on the new bracket.  At sweep 200, past max_iters, no row is active,
    the flag is 0 and the bracket stays."""
    rng = np.random.default_rng(3)
    d = 3
    st = np.zeros((8, d))
    st[0] = [0.2, 0.3, 0.5]
    st[3] = [2.0, 2.5, 0.51]
    st[1] = st[0] + loo_search._C * (st[3] - st[0])
    st[2] = st[0] + loo_search._R * (st[3] - st[0])
    st[4], st[5] = rng.uniform(1, 2, d), rng.uniform(1, 2, d)
    st[6], st[7] = st[1], st[2]
    fl = np.array([3, 2, 0])
    rows = sl.n_rows(sweep, d)
    ent = np.stack([rng.uniform(1, 2, rows), np.zeros(rows)], 1)
    f = ent[:, 0]
    base = torch.tensor([1.0, 2.0, 0.5], dtype=torch.float64)
    t_st = torch.full((2, 8, d), math.nan, dtype=torch.float64)
    t_fl = torch.zeros((2, d), dtype=torch.int32)
    t_st[sweep & 1], t_fl[sweep & 1] = torch.tensor(st), torch.tensor(fl)
    xmin = torch.empty(d, dtype=torch.float64)
    flag = torch.zeros(1, dtype=torch.int32)
    sl.golden_step(torch.tensor(ent), base, t_st, t_fl, xmin, flag, sweep,
                   TOL)
    n_iters = loo_search.max_iters(TOL, torch.float64)
    want_st, want_fl, nxt = _golden_np(st, fl, f, sweep, TOL, n_iters, d)
    out = (sweep + 1) & 1
    np.testing.assert_array_equal(t_st[out, :7].numpy(), want_st)
    np.testing.assert_array_equal(t_st[out, 7].numpy(), st[7])
    np.testing.assert_array_equal(t_fl[out].numpy(), want_fl)
    np.testing.assert_array_equal(t_st[sweep & 1].numpy(), st)
    assert int(flag) == int(nxt.any())
    pick = np.where(want_st[4] < want_st[5], want_st[1], want_st[2])
    np.testing.assert_array_equal(xmin.numpy(), pick * base.numpy())
    if sweep == 200:
        assert int(flag) == 0
        np.testing.assert_array_equal(want_st[:4], st[:4])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_twin_search_trace_equals_loo_search_ref(dtype):
    """One rank, the identity psum (called once a sweep, on its [rows, 2]):
    the twin search probes the same x as loo_search_ref (the
    single-device golden loop) on the same rows, its entropies within
    rounding (the sums are shifted by the nearest neighbour, not the max),
    and picks the same bandwidths; it stops on a flag read FLAG_LAG sweeps
    late, so it runs that many sweeps past the last probe."""
    pts, w = _data()
    q, qw = _t(pts[:N], dtype), _t(w[:N] / w[:N].sum(), dtype)
    base, ax, bx, cx = _bracket(pts, dtype)
    calls = []

    def counted(x):
        calls.append(x.shape)
        return x
    trace = loo_search.new_trace(q.T, TOL)
    got = sl.search(q, qw, q, qw, base, ax, bx, cx, tol=TOL, trace=trace,
                    psum=counted)
    sweeps = sl.LAST["sweeps"]
    assert len(calls) == sweeps
    assert calls[0] == (2 * D, 2) and set(calls[1:]) == {(D, 2)}
    assert sl.LAST["stop"] == "flag"
    assert sl.LAST["host_waits"] == sweeps - sl.FLAG_LAG
    ref_trace = loo_search.new_trace(q.T, TOL)
    xmin = loo_search.loo_search_ref(q.T.contiguous(), qw, base ** 2, ax, bx,
                                     cx, tol=TOL, trace=ref_trace)
    probes = ~torch.isnan(ref_trace[:, :, 0])
    assert torch.equal(probes, ~torch.isnan(trace[:, :, 0]))
    assert sweeps == int(probes.sum(dim=1).max()) - 1 + sl.FLAG_LAG
    torch.testing.assert_close(trace[:, :, 0], ref_trace[:, :, 0], rtol=0,
                               atol=0, equal_nan=True)
    tol_f = 1e-12 if dtype == torch.float64 else 2e-5
    torch.testing.assert_close(trace[:, :, 1], ref_trace[:, :, 1],
                               rtol=tol_f, atol=0, equal_nan=True)
    torch.testing.assert_close(got, xmin * base, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sweeps_past_the_stop_change_nothing(dtype):
    """The sweeps the search issues while its flag read lags: once sweep
    s's flag reads 0 (step s freezes every row), sweep s + 1's head folds
    sweep s's entropies, and from then on another sweep's entropies are 0
    on every row and its head, like the closing golden step, given any
    entropies, leaves the state, the picks and the flag as they were."""
    pts, w = _data()
    q, qw = _t(pts[:N], dtype), _t(w[:N] / w[:N].sum(), dtype)
    base, ax, bx, cx = _bracket(pts, dtype)
    xs, wp, st, fl = sl.stage(q, qw, ax, bx, cx)
    sw = sl.sweeps(q, qw, xs, wp, sl.nn_shift(q, xs, wp), base, st, fl,
                   tol=TOL)
    s = 0
    while True:
        sl.sweep(sw, s)
        if not int(sw.flag_v[s]):
            break
        s += 1
    assert 2 <= s <= loo_search.max_iters(TOL, dtype)
    sl.sweep(sw, s + 1)
    assert int(sw.flag_v[s + 1]) == 0

    def state(b):
        return [t.clone() for t in (st[b], fl[b], sw.xmin)]
    before = state((s + 1) & 1)
    rng = np.random.default_rng(5)
    noise = torch.tensor(np.stack([rng.uniform(-3, 3, D), [1.0, 0.0]], 1))
    sw.ent_v[s + 1].copy_(noise)
    sl.sweep(sw, s + 2)
    assert not sw.ent_v[s + 2].any() and int(sw.flag_v[s + 2]) == 0
    for a, b in zip(state((s + 2) & 1), before):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    flag = torch.ones(1, dtype=torch.int32)
    sl.golden_step(noise, base, st, fl, sw.xmin, flag, s + 2, TOL)
    assert int(flag) == 0
    for a, b in zip(state((s + 3) & 1), before):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_search_stops_at_max_iters(monkeypatch):
    """A search that reaches max_iters before its flag clears stops on the
    bound: the last sweep reads no flag (host_waits is sweeps - FLAG_LAG -
    1) and the picks are _golden_core's under the same bound."""
    pts, w = _data()
    q, qw = _t(pts[:N], torch.float64), _t(w[:N] / w[:N].sum(),
                                           torch.float64)
    base, ax, bx, cx = _bracket(pts, torch.float64)
    iters = 4
    monkeypatch.setattr(sl, "max_iters", lambda tol, dtype: iters)
    monkeypatch.setattr(loo_search, "max_iters", lambda tol, dtype: iters)
    got = sl.search(q, qw, q, qw, base, ax, bx, cx, tol=TOL)
    assert sl.LAST == dict(sweeps=iters + 1, host_waits=iters - sl.FLAG_LAG,
                           stop="max_iters")
    xmin = loo_search.loo_search_ref(q.T.contiguous(), qw, base ** 2, ax, bx,
                                     cx, tol=TOL)
    torch.testing.assert_close(got, xmin * base, rtol=0, atol=0)


def test_twin_stages_counted_and_bad_inputs_raise():
    """On the CPU every launch runs its twin (TWIN_STAGES: stage, nn_shift,
    one a sweep and the closing step; no launch); a half-precision input
    raises TypeError, a device other than the CPU or a card ValueError, a
    shape that does not fit ValueError."""
    pts, w = _data()
    q, qw = _t(pts[:N], torch.float64), _t(w[:N] / w[:N].sum(),
                                           torch.float64)
    base, ax, bx, cx = _bracket(pts, torch.float64)
    t0, k0 = sl.TWIN_STAGES, sl.LAUNCHES
    sl.search(q, qw, q, qw, base, ax, bx, cx)
    assert sl.TWIN_STAGES - t0 == 3 + sl.LAST["sweeps"]
    assert sl.LAUNCHES == k0
    with pytest.raises(TypeError, match="float32 or float64"):
        sl.stage(q.half(), qw.half(), ax.half(), bx.half(), cx.half())
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        sl.stage(q.to("meta"), qw, ax, bx, cx)
    with pytest.raises(ValueError, match="mw"):
        sl.stage(q, qw[:-1], ax, bx, cx)
    xs, wp, st, fl = sl.stage(q, qw, ax, bx, cx)
    shift = sl.nn_shift(q, xs, wp)
    with pytest.raises(ValueError, match="shift"):
        sl.sweeps(q, qw, xs, wp, shift[:, 1:], base, st, fl)
    with pytest.raises(ValueError, match="st"):
        sl.sweeps(q, qw, xs, wp, shift, base, st[0], fl)
    with pytest.raises(ValueError, match="q0"):
        sl.sweeps(q, qw, xs, wp, shift, base, st, fl, q0=-1)
