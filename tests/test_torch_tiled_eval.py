"""K1, the tiled mixture evaluator: the port's plain twin against the JAX
package's Pallas kernel (interpret mode) in float32 at rtol = atol = 2e-4
(the tolerance of tests/test_pallas_eval.py; the sums run in another
order), and against the dense JAX evaluators in float64 at rtol 1e-12.
The CUDA kernel itself is checked against the twin on the card
(tests/test_torch_cuda.py); here its launch plan is checked for coverage
at ragged shapes, and a NumPy emulation of its split, chunk, lazy-rescale
and cluster-merge arithmetic against the twin (float64, rtol 1e-12) and
the Pallas kernel (float32, rtol = atol = 2e-4).  The LOO mask's diagonal
offset (query m skips component m + diag) is held, in the twin, against
the JAX package's dense masked evaluation, and in the emulation, with the
kernel's per-block window over the chunks, on every launch plan."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from kde_tpu.ops import kernels as jkernels  # noqa: E402
from kde_tpu.ops.pallas_eval import pallas_log_eval  # noqa: E402
from kde_tpu_torch.ops import tiled_eval  # noqa: E402

SHAPES = [(100, 300, 2), (512, 512, 1), (70, 1200, 4)]


def _inputs(m, n, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(m, d))
    mu = rng.normal(size=(n, d))
    var = rng.uniform(0.2, 1.0, size=(n, d))
    w = rng.uniform(0.1, 1.0, size=n)
    return q, mu, var, w / w.sum()


def _t(x, dtype):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("m,n,d", SHAPES)
def test_ref_f32_matches_pallas(m, n, d):
    q, mu, var, w = _inputs(m, n, d)
    want = pallas_log_eval(*(jnp.asarray(x, jnp.float32)
                             for x in (q, mu, var, w)), interpret=True)
    got = tiled_eval.tiled_log_eval(*(_t(x, torch.float32)
                                      for x in (q, mu, var, w)))
    assert got.dtype == torch.float32 and tiled_eval.LAUNCHES == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n,d", [(300, 2), (1, 1)])
def test_ref_f32_loo_matches_pallas(n, d):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(n, d))
    var = np.full((n, d), 0.3)
    w = np.full(n, 1.0 / n)
    want = np.asarray(pallas_log_eval(
        *(jnp.asarray(x, jnp.float32) for x in (pts, pts, var, w)),
        loo=True, interpret=True))
    got = tiled_eval.tiled_log_eval(
        *(_t(x, torch.float32) for x in (pts, pts, var, w)), loo=True).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    if n == 1:
        assert np.isneginf(got).all()     # every component masked
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("m,n,d", SHAPES)
def test_ref_f64_matches_dense(m, n, d):
    q, mu, var, w = _inputs(m, n, d, seed=2)
    want = jkernels.log_eval(*(jnp.asarray(x) for x in (q, mu, var, w)))
    got = tiled_eval.tiled_log_eval_ref(*(_t(x, torch.float64)
                                          for x in (q, mu, var, w)), chunk=37)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_ref_f64_loo_matches_dense():
    rng = np.random.default_rng(3)
    n, d = 257, 3
    pts = rng.normal(size=(n, d))
    var = rng.uniform(0.1, 0.5, size=(n, d))
    w = rng.uniform(0.1, 1.0, size=n)
    w /= w.sum()
    want = jkernels.log_eval_loo(*(jnp.asarray(x) for x in (pts, var, w)))
    tp, tv, tw = (_t(x, torch.float64) for x in (pts, var, w))
    got = (tiled_eval.tiled_log_eval_ref(tp, tp, tv, tw, loo=True, chunk=50)
           - torch.log1p(-tw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_ref_zero_weight_components():
    """Zero-weight components (log w = -inf) add nothing."""
    q, mu, var, w = _inputs(20, 40, 2, seed=4)
    w2 = np.concatenate([w, np.zeros(5)])
    mu2 = np.concatenate([mu, np.zeros((5, 2))])
    var2 = np.concatenate([var, np.ones((5, 2))])
    a = tiled_eval.tiled_log_eval_ref(*(_t(x, torch.float64)
                                        for x in (q, mu, var, w)))
    b = tiled_eval.tiled_log_eval_ref(*(_t(x, torch.float64)
                                        for x in (q, mu2, var2, w2)))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-14)


# ---- the kernel's launch plan and its arithmetic, emulated in NumPy ---------

RAGGED = (1, 31, 127, 128, 129, 4097, 20000)
CHUNKS = (8, 16)          # the kernel's J: 16 at d <= 2, 8 above
CHUNK_MAX = max(CHUNKS)
DIMS = (1, 2, 3, 9, 16)
SMS = (132, 114, 16, 1)


@pytest.mark.parametrize("m,n,loo", [(m, n, False) for m in RAGGED
                                     for n in RAGGED]
                         + [(n, n, True) for n in RAGGED])
def test_launch_plan_covers_every_pair_once(m, n, loo):
    """Query blocks cover the M queries once and the splits the N
    components once (no split empty, each starting on a whole chunk),
    within the cluster limit and MAX_DIM; the chosen plan is the cheapest
    of :func:`plans`."""
    del loo                         # the plan does not depend on it
    for d in DIMS:
        for sms in SMS:
            p = tiled_eval.launch_plan(m, n, d, sms)
            rows = p.threads * p.rows_per_thread
            assert p.rows_per_thread == tiled_eval.rows_per_thread(d)
            assert p.threads in tiled_eval.THREADS
            costs = {q: c for c, q in tiled_eval.plans(m, n, d, sms)}
            assert costs[p] == min(costs.values())
            assert p.grid == (-(-m // rows), p.splits)
            assert (p.grid[0] - 1) * rows < m <= p.grid[0] * rows
            assert 1 <= p.splits <= tiled_eval.MAX_SPLITS
            assert p.per_split % tiled_eval.SPLIT_ALIGN == 0
            assert tiled_eval.SPLIT_ALIGN % CHUNK_MAX == 0
            assert (p.splits - 1) * p.per_split < n <= p.splits * p.per_split
            starts = [s * p.per_split for s in range(p.splits)]
            ends = [min(n, s + p.per_split) for s in starts]
            assert starts[0] == 0 and ends[-1] == n and all(
                e == s2 for e, s2 in zip(ends, starts[1:]))
    with pytest.raises(ValueError, match="MAX_DIM|outside"):
        tiled_eval.launch_plan(m, n, tiled_eval.MAX_DIM + 1, 132)


def emulate(q, mu, var, w, loo, plan, dtype, chunk, diag=0):
    """csrc/tiled_eval.cu's arithmetic in NumPy ``dtype``: per split,
    chunks of ``chunk`` components (padding has weight 0; a split starts on
    a whole chunk, so the staged tiles do not change the chunks) with the
    chunk's largest c, the 64/8 lazy rescale in log2 units, four partial
    sums per query, then the splits merged in rank order.  (numpy rounds
    the kernel's fma twice.)  With ``loo``, query m skips component
    m + diag, and only in the chunks that the kernel's window finds for
    the query's block of ``threads * rows_per_thread`` rows; a ``diag``
    that skips no column in [0, N) runs unmasked, as the C entry does."""
    f = np.dtype(dtype).type
    q, mu, var, w = (np.asarray(x, dtype=dtype) for x in (q, mu, var, w))
    m_q, d = q.shape
    n = mu.shape[0]
    none, bound, resc = -np.finfo(dtype).max, f(64.0), f(8.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = f(0.72134752044448170) / var
        lv = np.zeros(n, dtype)
        for k in range(d):
            lv = lv + np.log2(var[:, k])
        c = np.log2(w) - f(0.5) * lv
        rows = np.arange(m_q)
        block = plan.threads * plan.rows_per_thread
        q_base = rows // block * block          # each query's block start
        loo = loo and -m_q < diag < n
        parts = []
        for sp in range(plan.splits):
            nb, ne = sp * plan.per_split, min(n, (sp + 1) * plan.per_split)
            m = np.full(m_q, none, dtype)
            lim = m + bound
            a = np.zeros((m_q, 4), dtype)
            for n0 in range(nb, ne, chunk):
                idx = n0 + np.arange(chunk)
                ok = idx < ne
                idc = np.minimum(idx, n - 1)
                cc = np.where(ok, c[idc], -np.inf).astype(dtype)
                cmax = cc.max()
                l = np.broadcast_to(cc, (m_q, chunk)).copy()
                for k in range(d):
                    t = q[:, k:k + 1] - np.where(ok, mu[idc, k], 0)
                    l = l - (t * np.where(ok, h[idc, k], 1)) * t
                if loo:
                    window = ((n0 < q_base + diag + block)
                              & (n0 + chunk > q_base + diag))
                    l[window[:, None]
                      & (rows[:, None] + diag == idx[None, :])] = -np.inf
                cm = l.max(axis=1)
                up = (cmax > lim) & (cm > m + resc)
                fct = np.exp2(np.where(up, m - cm, 0)).astype(dtype)
                a = np.where(up[:, None], a * fct[:, None], a)
                m = np.where(up, cm, m)
                lim = np.where(up, cm + bound, lim).astype(dtype)
                e = np.exp2(l - m[:, None]).astype(dtype)
                for jj in range(chunk):
                    a[:, jj & 3] = a[:, jj & 3] + e[:, jj]
            parts.append((m, (a[:, 0] + a[:, 1]) + (a[:, 2] + a[:, 3])))
        m, s = parts[0]
        for mi, si in parts[1:]:
            mn = np.maximum(m, mi)
            s = s * np.exp2(m - mn) + si * np.exp2(mi - mn)
            m = mn
        return ((np.log2(s) + m) * f(np.log(2.0))
                - f(0.5 * d * np.log(2.0 * np.pi))).astype(dtype)


def _emu_inputs(m, n, d, loo, seed, zero=None):
    q, mu, var, w = _inputs(m, n, d, seed)
    if loo:
        q = mu
    if zero is not None:
        w[zero] = 0.0
        w /= w.sum()
    return q, mu, var, w


def _same(got, want, **tol):
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **tol)


EMU_CASES = [(1, 1, 1, True), (31, 127, 3, False), (127, 31, 2, False),
             (129, 4097, 2, False), (4097, 129, 9, False),
             (128, 128, 16, True), (4097, 4097, 1, True),
             (20000, 31, 1, False), (31, 20000, 2, False)]


@pytest.mark.parametrize("m,n,d,loo", EMU_CASES)
def test_emulation_f64_matches_twin(m, n, d, loo):
    q, mu, var, w = _emu_inputs(m, n, d, loo, seed=m + n + d)
    plan = tiled_eval.launch_plan(m, n, d, 132)
    want = tiled_eval.tiled_log_eval_ref(
        *(_t(x, torch.float64) for x in (q, mu, var, w)), loo=loo).numpy()
    for chunk in CHUNKS:
        got = emulate(q, mu, var, w, loo, plan, np.float64, chunk)
        _same(got, want, rtol=1e-12)
        if m == n == 1 and loo:
            assert np.isneginf(got).all()


def test_emulation_zero_weight_split_and_split_boundary():
    """A whole split of zero-weight components adds nothing, and the LOO
    diagonal of the queries either side of a split boundary is masked."""
    n, d = 4097, 2
    plan = tiled_eval.launch_plan(n, n, d, 132)
    assert plan.splits >= 3
    dead = slice(plan.per_split, 2 * plan.per_split)
    q, mu, var, w = _emu_inputs(n, n, d, True, seed=5, zero=dead)
    got = emulate(q, mu, var, w, True, plan, np.float64, 16)
    want = tiled_eval.tiled_log_eval_ref(
        *(_t(x, torch.float64) for x in (q, mu, var, w)), loo=True).numpy()
    _same(got, want, rtol=1e-12)
    keep = np.ones(n, bool)
    keep[dead] = False
    for i in (plan.per_split - 1, plan.per_split, 2 * plan.per_split):
        keep_i = keep.copy()
        keep_i[i] = False            # its own component, masked
        ref = tiled_eval.tiled_log_eval_ref(
            _t(q[i:i + 1], torch.float64),
            *(_t(x[keep_i], torch.float64) for x in (mu, var, w))).numpy()
        np.testing.assert_allclose(got[i], ref[0], rtol=1e-12)


@pytest.mark.parametrize("m,n,d,loo", [(129, 4097, 2, False),
                                       (4097, 129, 1, False),
                                       (300, 300, 2, True), (1, 1, 1, True)])
def test_emulation_f32_matches_pallas(m, n, d, loo):
    q, mu, var, w = _emu_inputs(m, n, d, loo, seed=7 + m + n)
    plan = tiled_eval.launch_plan(m, n, d, 132)
    want = np.asarray(pallas_log_eval(
        *(jnp.asarray(x, jnp.float32) for x in (q, mu, var, w)), loo=loo,
        interpret=True))
    for chunk in CHUNKS:
        got = emulate(q, mu, var, w, loo, plan, np.float32, chunk)
        _same(got, want, rtol=2e-4, atol=2e-4)


# ---- the LOO mask's diagonal offset: query m skips component m + diag -------

DIAG_SHAPES = [(300, 700, 2), (700, 300, 3), (257, 257, 1)]
DIAG_NAMES = ("0", "+1", "-1", "+block", "-block", "split", "last_col",
              "first_col", "past_n", "past_m")


def _diag(name, m, n, d):
    """The offset ``name`` for an ``[m, d] x [n, d]`` call on 132 SMs: 0,
    +-1, +- one query block of the chosen plan (threads * rows_per_thread
    rows), one that lays query block 0's skipped columns across the plan's
    first split boundary and enters its chunks part-way, one that leaves a
    column to the first row only (n - 1) and to the last row only
    (1 - m), and two past either end, which skip nothing."""
    plan = tiled_eval.launch_plan(m, n, d, 132)
    block = plan.threads * plan.rows_per_thread
    assert plan.splits > 1
    return {"0": 0, "+1": 1, "-1": -1, "+block": block, "-block": -block,
            "split": plan.per_split - block // 2 - 3, "last_col": n - 1,
            "first_col": 1 - m, "past_n": max(m, n) + 5,
            "past_m": -max(m, n) - 5}[name]


def _diag_inputs(m, n, d, diag, seed):
    """Queries that sit on the components they skip (query i is mean
    i + diag where that is a column), so a mask missed or misplaced moves
    the row's value far beyond every tolerance here."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(m, d))
    mu = rng.normal(size=(n, d))
    i = np.arange(m)
    on = (i + diag >= 0) & (i + diag < n)
    q[on] = mu[i[on] + diag]
    var = rng.uniform(0.05, 0.3, size=(n, d))
    w = rng.uniform(0.1, 1.0, size=n)
    return q, mu, var, w / w.sum()


def _jax_masked(q, mu, var, w, diag):
    """The JAX package's dense float64 evaluation with component
    m + diag masked out of query m."""
    return np.asarray(jkernels.log_gauss_mixture(
        *(jnp.asarray(x) for x in (q, mu, var)), jnp.log(jnp.asarray(w)),
        exclude=jnp.arange(q.shape[0]) + diag))


@pytest.mark.parametrize("name", DIAG_NAMES)
@pytest.mark.parametrize("m,n,d", DIAG_SHAPES)
def test_ref_diag_matches_jax_dense(m, n, d, name):
    """The twin with an offset against the JAX package's dense masked
    evaluation: float64 at rtol 1e-12 (in query chunks of 37, so the offset
    moves with each chunk's start), and the float32 wrapper on the CPU
    against it at rtol = atol = 1e-5; an offset past either end equals the
    evaluation without LOO."""
    diag = _diag(name, m, n, d)
    args = _diag_inputs(m, n, d, diag, seed=m + n + d)
    want = _jax_masked(*args, diag)
    t64 = [_t(x, torch.float64) for x in args]
    got = tiled_eval.tiled_log_eval_ref(*t64, loo=True, diag=diag, chunk=37)
    _same(got.numpy(), want, rtol=1e-12)
    got32 = tiled_eval.tiled_log_eval(*(_t(x, torch.float32) for x in args),
                                      loo=True, diag=diag)
    assert got32.dtype == torch.float32 and tiled_eval.LAUNCHES == 0
    _same(got32.numpy(), want, rtol=1e-5, atol=1e-5)
    if name.startswith("past"):
        assert torch.equal(got, tiled_eval.tiled_log_eval_ref(*t64,
                                                              chunk=37))


@pytest.mark.parametrize("m,n,d", [(n, n, d) for n, d in
                                   ((300, 2), (257, 1), (129, 9))])
def test_ref_diag_zero_is_loo(m, n, d):
    """diag = 0 is the LOO mask as it was, element for element, through
    the twin at several chunk sizes and through the CPU wrapper."""
    q, mu, var, w = _emu_inputs(m, n, d, True, seed=n + d)
    for dtype in (torch.float32, torch.float64):
        args = [_t(x, dtype) for x in (q, mu, var, w)]
        for chunk in (None, 1, 37, n):
            assert torch.equal(
                tiled_eval.tiled_log_eval_ref(*args, loo=True, chunk=chunk),
                tiled_eval.tiled_log_eval_ref(*args, loo=True, diag=0,
                                              chunk=chunk))
        assert torch.equal(tiled_eval.tiled_log_eval(*args, loo=True),
                           tiled_eval.tiled_log_eval(*args, loo=True,
                                                     diag=0))


@pytest.mark.parametrize("name", DIAG_NAMES)
@pytest.mark.parametrize("m,n,d", DIAG_SHAPES)
def test_emulation_diag_every_plan(m, n, d, name):
    """Every launch plan of the shape (64 or 128 threads, R rows a thread,
    1..8 component splits), its per-block diagonal window and per-pair
    mask emulated at the offset, in float64 against the twin at rtol
    1e-12."""
    diag = _diag(name, m, n, d)
    args = _diag_inputs(m, n, d, diag, seed=m + n + d)
    want = tiled_eval.tiled_log_eval_ref(
        *(_t(x, torch.float64) for x in args), loo=True, diag=diag).numpy()
    chunk = 16 if d <= 2 else 8                 # the kernel's J
    plans = [p for _, p in tiled_eval.plans(m, n, d, 132)]
    assert {p.threads for p in plans} == set(tiled_eval.THREADS)
    for plan in plans:
        _same(emulate(*args, True, plan, np.float64, chunk, diag), want,
              rtol=1e-12)


@pytest.mark.parametrize("name", ["0", "+block", "-block", "split",
                                  "last_col", "first_col"])
def test_emulation_diag_fully_masked_row(name):
    """One positive-weight component: the one row that skips it is -inf
    on every plan and in the twin, every other row finite."""
    m, n, d = 300, 700, 2
    diag = _diag(name, m, n, d)
    row = min(max(m // 2, -diag), n - 1 - diag, m - 1)
    q, mu, var, _ = _diag_inputs(m, n, d, diag, seed=9)
    w = np.zeros(n)
    w[row + diag] = 1.0
    want = tiled_eval.tiled_log_eval_ref(
        *(_t(x, torch.float64) for x in (q, mu, var, w)), loo=True,
        diag=diag).numpy()
    dead = np.zeros(m, bool)
    dead[row] = True
    np.testing.assert_array_equal(np.isneginf(want), dead)
    for _, plan in tiled_eval.plans(m, n, d, 132):
        _same(emulate(q, mu, var, w, True, plan, np.float64, 16, diag), want,
              rtol=1e-12)


def test_build_hash_covers_local_headers(tmp_path):
    """nvcc_build names a library by the hash of its source and every
    local header the source includes, transitively: editing a header
    that two kernels share changes both names, so no stale library is
    loaded.  The Gibbs kernels include the counter generator's header."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n#include <math.h>\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text("// v1\n")
    one = tiled_eval.source_bytes(tmp_path / "a.cu")
    assert b"// v1" in one and b"#pragma once" in one
    (tmp_path / "g.cuh").write_text("// v2\n")
    assert tiled_eval.source_bytes(tmp_path / "a.cu") != one
    from kde_tpu_torch.ops import gibbs_chain, gibbs_select
    header = (tiled_eval.Path(gibbs_chain.SOURCE).parent
              / "counter_rng.cuh").read_bytes()
    for mod in (gibbs_chain, gibbs_select):
        assert header in tiled_eval.source_bytes(mod.SOURCE)
