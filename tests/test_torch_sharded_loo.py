"""The sharded LOOCV search's phases (``kde_tpu_torch/ops/sharded_loo.py``,
K7's plain twins on the CPU) against float64 NumPy, over a split of the
problem into shards with the diagonal at each shard's offsets, and the
twin search against the single-device search ``loo_search_ref``.

No process group: the collectives are composed by hand (a shard's
``nn_shift`` is min-reduced and its ``probe_sums`` summed across the
shards) or, in ``search``, are the identity of one shard.  The data has
non-uniform weights, zero-weight padding, a query whose shard holds no
live neighbour for it and, in one case, a query with none at all (its
objective +inf)."""
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

N, D, PAD = 37, 2, 3            # 40 rows: 2 x 2 shards of 20 / 20
TOL = 1e-2


def _data(lonely=False):
    """Points [N + PAD, D], weights summing to 1 over the first N (the
    padding weighs 0).  Column shard 0 holds rows 0..19, where only row 5
    is live: query 5 has no live neighbour on it.  ``lonely``: row 5 is
    the only live point (weight 0.5, as a phase may be given it)."""
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stage_and_nn_shift_against_numpy(dtype):
    """Each column shard's staging (+inf where w = 0, whole tiles) and its
    nearest live neighbours at the global diagonal; min-reduced over the
    shards they are the whole problem's, bitwise (the squared differences
    round alike)."""
    pts, w = _data()
    base, ax, bx, cx = _bracket(pts, dtype)
    n = N + PAD
    q = _t(pts, dtype)
    local = []
    for cols in _shards(n, 2):
        m, mw = _t(pts[cols.start:cols.stop], dtype), _t(w[cols.start:
                                                         cols.stop], dtype)
        xs, wp, st, fl = sl.stage(m, mw, ax, bx, cx)
        assert xs.shape == (D, sl.TILE) and wp.shape == (sl.TILE,)
        live = w[cols.start:cols.stop] > 0
        np.testing.assert_array_equal(
            xs[:, :len(cols)].numpy(),
            np.where(live[None, :], pts[cols.start:cols.stop].T.astype(
                xs.numpy().dtype), np.inf))
        assert torch.isinf(xs[:, len(cols):]).all()
        assert (wp[len(cols):] == 0).all() and fl.tolist() == [2] * D
        got = sl.nn_shift(q, xs, wp, 0, cols.start)
        want = _np_nn(pts.astype(xs.numpy().dtype).astype(np.float64), w,
                      range(n), cols)
        np.testing.assert_allclose(got.double().numpy(), want,
                                   rtol=1e-6 if dtype == torch.float32
                                   else 0)
        local.append(got)
    assert math.isinf(float(local[0][0, 5]))    # no live neighbour on 0
    whole = torch.minimum(*local)
    assert torch.isfinite(whole[:, :N]).all()
    m_all = sl.stage(q, _t(w, dtype), ax, bx, cx)
    torch.testing.assert_close(whole, sl.nn_shift(q, *m_all[:2]), rtol=0,
                               atol=0)
    # the golden state of sweep 0, as _golden_core places x1 and x2
    st = m_all[2]
    wide = (cx - bx).abs() > (bx - ax).abs()
    torch.testing.assert_close(st[sl.PR0], torch.where(
        wide, bx, bx - loo_search._C * (bx - ax)), rtol=0, atol=0)
    torch.testing.assert_close(st[sl.PR1], torch.where(
        wide, bx + loo_search._C * (cx - bx), bx), rtol=0, atol=0)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-5)])
@pytest.mark.parametrize("lonely", [False, True])
def test_probe_sums_and_entropy_over_2x2_shards(dtype, rtol, lonely):
    """Sweep 0 (x1 and x2 of both dimensions, 4 rows) over a 2 x 2 split:
    each (chains, kernels) shard's sums, summed over the kernels shards,
    equal NumPy's sums of the whole row; each chains shard's (h, bad),
    summed, NumPy's.  ``lonely``: query 5 has no live neighbour at all,
    so its sum is 0, log p -inf and every row's objective +inf, with no
    NaN."""
    pts, w = _data(lonely)
    n = N + PAD
    base, ax, bx, cx = _bracket(pts, dtype)
    xs_w = [sl.stage(_t(pts[c.start:c.stop], dtype),
                     _t(w[c.start:c.stop], dtype), ax, bx, cx)
            for c in _shards(n, 2)]
    st, fl = xs_w[0][2], xs_w[0][3]
    var = ((torch.cat([st[sl.PR0], st[sl.PR1]]) ** 2)
           * base.repeat(2) ** 2).double().numpy()
    ent = torch.zeros((2 * D, 2), dtype=torch.float64)
    all_sums = []
    for rows in _shards(n, 2):
        q = _t(pts[rows.start:rows.stop], dtype)
        shift = torch.minimum(*[sl.nn_shift(q, xs, wp, rows.start, c.start)
                                for (xs, wp, _, _), c in
                                zip(xs_w, _shards(n, 2))])
        sums = sum(sl.probe_sums(q, xs, wp, shift, base, st, fl, 0,
                                 rows.start, c.start)
                   for (xs, wp, _, _), c in zip(xs_w, _shards(n, 2)))
        pts_r = pts.astype(q.numpy().dtype).astype(np.float64)
        want = _np_sums(pts_r, w, rows, range(n), shift.double().numpy(),
                        var)
        np.testing.assert_allclose(sums.numpy(), want, rtol=rtol, atol=0)
        all_sums.append(sums)
        ent += sl.probe_entropy(sums, shift, _t(w[rows.start:rows.stop],
                                                dtype), base, st, fl, 0)
    assert not torch.isnan(ent).any()
    shift_all = _np_nn(pts, w, range(n), range(n))
    want = _np_entropy(np.concatenate([s.numpy() for s in all_sums], 1),
                       shift_all, w, var)
    if lonely:
        assert (ent[:, 1] == 1).all() and (want[:, 1] == 1).all()
        assert float(all_sums[0][0, 5]) == 0.0
    else:
        assert (ent[:, 1] == 0).all()
        np.testing.assert_allclose(ent[:, 0].numpy(), want[:, 0], rtol=rtol)
    xmin = torch.empty(D, dtype=dtype)
    flag = torch.zeros(1, dtype=torch.int32)
    sl.golden_step(ent, base, st, fl, xmin, flag, 0, TOL)
    f = st[sl.F1:sl.F2 + 1]
    assert torch.isinf(f).all() if lonely else torch.isfinite(f).all()


def _golden_np(st, fl, f, sweep, tol, n_iters, d):
    """NumPy float64 of _golden_core's step after sweep ``sweep``."""
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
    return (np.stack([nx0, nx1, nx2, nx3, f1, f2, probe]),
            take2.astype(int) | (active.astype(int) << 1))


@pytest.mark.parametrize("sweep", [0, 1, 7, 200])
def test_golden_step_against_numpy(sweep):
    """The masked update of _golden_core from a state with one frozen row
    (bit 1 of fl clear), one taking x2 and one taking x1; at sweep 200,
    past max_iters, no row is active and the flag is 0."""
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
    t_st, t_fl = torch.tensor(st), torch.tensor(fl, dtype=torch.int32)
    xmin = torch.empty(d, dtype=torch.float64)
    flag = torch.zeros(1, dtype=torch.int32)
    sl.golden_step(torch.tensor(ent), base, t_st, t_fl, xmin, flag, sweep,
                   TOL)
    n_iters = loo_search.max_iters(TOL, torch.float64)
    want_st, want_fl = _golden_np(st, fl, f, sweep, TOL, n_iters, d)
    np.testing.assert_array_equal(t_st[:7].numpy(), want_st)
    np.testing.assert_array_equal(t_fl.numpy(), want_fl)
    assert int(flag) == int((want_fl & 2).any())
    pick = np.where(want_st[4] < want_st[5], want_st[1], want_st[2])
    np.testing.assert_array_equal(xmin.numpy(), pick * base.numpy())
    if sweep == 200:
        assert int(flag) == 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_twin_search_trace_equals_loo_search_ref(dtype):
    """One shard, identity collectives: the twin search probes the same x
    as loo_search_ref (the single-device golden loop) on the same rows,
    its entropies within rounding (the sums are shifted by the nearest
    neighbour, not the max), and picks the same bandwidths; it stops on a
    flag read FLAG_LAG sweeps late, so it runs that many sweeps past the
    last probe."""
    pts, w = _data()
    q, qw = _t(pts[:N], dtype), _t(w[:N] / w[:N].sum(), dtype)
    base, ax, bx, cx = _bracket(pts, dtype)
    calls = []

    def counted(x):
        calls.append(x.shape)
        return x
    trace = loo_search.new_trace(q.T, TOL)
    got = sl.search(q, qw, q, qw, base, ax, bx, cx, tol=TOL, trace=trace,
                    pmin=counted, psum_kernels=counted,
                    psum_chains=counted)
    sweeps = sl.LAST["sweeps"]
    assert len(calls) == 1 + 2 * sweeps
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
    """The sweeps the search issues while its flag read lags: once a
    golden step has cleared the flag, another sweep's entropies are 0 on
    every row and its golden step, given any entropies, leaves the state,
    the picks and the flag as they were."""
    pts, w = _data()
    q, qw = _t(pts[:N], dtype), _t(w[:N] / w[:N].sum(), dtype)
    base, ax, bx, cx = _bracket(pts, dtype)
    xs, wp, st, fl = sl.stage(q, qw, ax, bx, cx)
    shift = sl.nn_shift(q, xs, wp)
    xmin = torch.empty(D, dtype=dtype)
    flag = torch.zeros(1, dtype=torch.int32)
    sweep = 0
    while True:
        sums = sl.probe_sums(q, xs, wp, shift, base, st, fl, sweep)
        ent = sl.probe_entropy(sums, shift, qw, base, st, fl, sweep)
        sl.golden_step(ent, base, st, fl, xmin, flag, sweep, TOL)
        sweep += 1
        if not int(flag):
            break
    assert 3 <= sweep <= loo_search.max_iters(TOL, dtype)
    before = [t.clone() for t in (st, fl, xmin, flag)]
    sums = sl.probe_sums(q, xs, wp, shift, base, st, fl, sweep)
    ent = sl.probe_entropy(sums, shift, qw, base, st, fl, sweep)
    assert not ent.any()
    rng = np.random.default_rng(5)
    noise = torch.tensor(np.stack([rng.uniform(-3, 3, D), [1.0, 0.0]], 1))
    for e in (ent, noise):
        sl.golden_step(e, base, st, fl, xmin, flag, sweep, TOL)
        for a, b in zip((st, fl, xmin, flag), before):
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
    """On the CPU every phase runs its twin (TWIN_STAGES, no launch); a
    half-precision input raises TypeError, a device other than the CPU or
    a card ValueError, a shape that does not fit ValueError."""
    pts, w = _data()
    q, qw = _t(pts[:N], torch.float64), _t(w[:N] / w[:N].sum(),
                                           torch.float64)
    base, ax, bx, cx = _bracket(pts, torch.float64)
    t0, k0 = sl.TWIN_STAGES, sl.LAUNCHES
    sl.search(q, qw, q, qw, base, ax, bx, cx)
    assert sl.TWIN_STAGES - t0 == 2 + 3 * sl.LAST["sweeps"]
    assert sl.LAUNCHES == k0
    with pytest.raises(TypeError, match="float32 or float64"):
        sl.stage(q.half(), qw.half(), ax.half(), bx.half(), cx.half())
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        sl.stage(q.to("meta"), qw, ax, bx, cx)
    with pytest.raises(ValueError, match="mw"):
        sl.stage(q, qw[:-1], ax, bx, cx)
    xs, wp, st, fl = sl.stage(q, qw, ax, bx, cx)
    with pytest.raises(ValueError, match="shift"):
        sl.probe_sums(q, xs, wp, torch.zeros(D, N - 1, dtype=q.dtype), base,
                      st, fl, 0)
