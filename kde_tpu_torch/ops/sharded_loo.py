"""The local work of the sharded LOOCV golden search (the port's K7; on the
TPU the inline ``jnp`` probe of
``kde_tpu/parallel/eval.py::ksize_bandwidths_sharded`` :151-191, XLA-fused
in its ``shard_map`` program around the ``lax.while_loop`` of
``kde_tpu/ops/loocv.py:180``).

The padded query rows are split over every rank of the mesh: a rank holds
the queries ``q [mq, d]`` (weights ``qw``), global rows ``q0 + i``, and
all ``N`` components ``m [N, d]`` (weights ``mw``, summing to 1), so a
query's sum runs over every column on one rank.  :func:`search` runs the
golden search of every dimension at once (``ops/loo_search.py::
_golden_core``'s trajectory) as::

    xs, wp, st, fl = stage(m, mw, ax, bx, cx)
    shift = nn_shift(q, xs, wp, q0)
    sw = sweeps(q, qw, xs, wp, shift, base, st, fl, q0=q0, tol=tol)
    for each sweep s:
        sweep(sw, s)                      # step s - 1, then sweep s's
        psum(sw.ent_v[s])                 #   (h, bad) -> one collective
    golden_step(sw.ent_v[s], ...)         # the last step, the picks

so a search calls one collective a sweep: the psum of its ``[rows, 2]``
over every rank of the mesh.  ``shift`` is each query's least squared
distance to a live neighbour (``+inf`` where it has none), which does not
depend on the probe: every term of a sum is at most its weight.  The
golden state lives in ``st [2, 8, d]`` (x0, x1, x2, x3, f1, f2 and the
probes pr0, pr1), ``fl [2, d]`` (bit 0 take2, bit 1 active), double-buffered
by the sweep's parity, on the tensors' device.  A sweep's launch applies
the previous sweep's golden step in its head and writes the active test of
the next step to ``flags[s]``, so the host never reads the sweep it has
just issued: it reads the flag of the sweep ``FLAG_LAG`` back, from pinned
memory after that sweep's event, and stops when it is 0; the sweeps issued
meanwhile change nothing (frozen rows take no work).

CUDA tensors launch the hand-written kernels of ``csrc/sharded_loo.cu``
(built with nvcc ``--fmad=false`` into ``_build/`` at the first launch;
the probe arithmetic is ``csrc/loo_probe.cuh``, K4's); no launch builds an
``[mq, N]`` or ``[rows, mq]`` tensor on the card.  :func:`sweeps` checks
shapes, types and devices and allocates every buffer once a search, so a
sweep is one ctypes call on prepared pointers.  CPU tensors take each
launch's plain twin ``*_ref``, eager torch over query chunks, with the same
signature (each counted in ``TWIN_STAGES``).  A failed build, a refused
launch or an input the kernels do not take raises; nothing falls back.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from collections import namedtuple
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .loo_search import (_C, _R, golden_active, golden_fold, golden_start,
                         golden_update, max_iters, search_tol)
from .tiled_eval import nvcc_build

# Launches of the kernels; a run sets it to 0 and reads it to show the path
# went through them.
LAUNCHES = 0
# Launches that ran on the twins (CPU tensors).
TWIN_STAGES = 0
# The host reads the active flag of the sweep this many sweeps back.
FLAG_LAG = 1
# The last search's counts: sweeps, host_waits (lagged flag reads) and
# stop ("flag": a flag read was 0; "max_iters": the bound ended it).
LAST: dict = {}

TILE = 1024                 # csrc/loo_probe.cuh's kTile: staged columns
GROUP = 32                  # kGroup: the queries of a block
TWIN_CHUNK_ELEMS = 1 << 24  # the twins' [chunk, n_pad] pieces
LOG_2PI = float(np.log(2 * np.pi))
_LOG2E = 1.4426950408889634
X0, X1, X2, X3, F1, F2, PR0, PR1 = range(8)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "sharded_loo.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lib = None
BUILD_LOG = ""
_FLOATS = (torch.float32, torch.float64)


def build() -> Path:
    """Compile ``csrc/sharded_loo.cu`` (once per source, its headers and
    the flags) and return the shared library's path; a failed build
    raises."""
    global BUILD_LOG
    out, log = nvcc_build(SOURCE, NVCC_FLAGS, "sharded_loo")
    BUILD_LOG = log or BUILD_LOG
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_double)
        lib.kde_k7_stage.argtypes = [vp] * 9 + [i] * 3 + [f, i, vp]
        lib.kde_k7_nn_shift.argtypes = [vp] * 3 + [ll] + [i] * 3 + [vp, i,
                                                                    vp]
        lib.kde_k7_sweep.argtypes = [vp, i]
        lib.kde_k7_golden_step.argtypes = [vp] * 7 + [i] * 3 + [f] * 3 + [
            i, vp]
        for fn in (lib.kde_k7_stage, lib.kde_k7_nn_shift, lib.kde_k7_sweep,
                   lib.kde_k7_golden_step):
            fn.restype = i
        _lib = lib
    return _lib


def n_padded(nk: int) -> int:
    """The staged columns of ``nk`` components: whole tiles."""
    return max(1, -(-nk // TILE)) * TILE


def n_rows(sweep: int, d: int) -> int:
    """Probe rows of a sweep: x1 and x2 of every dimension first, then
    one a dimension."""
    return 2 * d if sweep == 0 else d


# A sweep's grid: ``groups`` of GROUP queries x ``rows`` probe rows x
# ``chunks`` of the columns, ``tiles`` staged tiles a chunk (the last may
# hold fewer); block b is (row, group, chunk) = divmod order below.
Plan = namedtuple("Plan", "groups rows chunks tiles")


def sweep_plan(mq: int, n_pad: int, rows: int, sms: int) -> Plan:
    """The grid of a sweep of ``rows`` probe rows over ``mq`` queries and
    ``n_pad`` staged columns on a card of ``sms`` SMs: a block a (row,
    group of GROUP queries); where that gives fewer than two blocks an SM
    (few queries a rank), the columns are also cut into chunks of
    ``tiles`` whole tiles (the last may hold fewer, never none), the
    longest that give two (or one tile a chunk)."""
    groups = -(-mq // GROUP)
    n_tiles = n_pad // TILE
    want = -(-2 * sms // (groups * rows))
    tiles = max(1, n_tiles // want)
    return Plan(groups, rows, -(-n_tiles // tiles), tiles)


def plan_block(plan: Plan, b: int, mq: int, n_pad: int):
    """Block ``b`` of ``plan`` as the kernel decodes it: its probe row, its
    queries ``[q_lo, q_hi)`` and its columns ``[c_lo, c_hi)``."""
    rg, c = divmod(b, plan.chunks)
    row, g = divmod(rg, plan.groups)
    t0 = c * plan.tiles
    return (row, (g * GROUP, min(mq, (g + 1) * GROUP)),
            (t0 * TILE, min(n_pad, (t0 + plan.tiles) * TILE)))


def _device(*tensors) -> torch.device:
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1 or next(iter(devs)).type not in ("cpu", "cuda"):
        raise ValueError("sharded_loo: inputs must all lie on the CPU or on "
                         f"one CUDA device, got {sorted(map(str, devs))}")
    return devs.pop()


def _dtype(*tensors) -> torch.dtype:
    dts = {t.dtype for t in tensors}
    if len(dts) != 1 or next(iter(dts)) not in _FLOATS:
        raise TypeError("sharded_loo takes float32 or float64 throughout, "
                        f"got {sorted(map(str, dts))}")
    return dts.pop()


def _want(**shapes):
    bad = [f"{k} {tuple(t.shape)} (want {s})"
           for k, (t, s) in shapes.items() if tuple(t.shape) != s]
    if bad:
        raise ValueError(f"sharded_loo: {', '.join(bad)}")


def _on_kernel(dev: torch.device) -> bool:
    global TWIN_STAGES
    if dev.type == "cpu":
        TWIN_STAGES += 1
        return False
    return True


def _rc(name: str, rc: int):
    global LAUNCHES
    if rc != 0:
        raise RuntimeError(f"kde_k7_{name} launch failed: CUDA error {rc}")
    LAUNCHES += 1


def _stream(dev):
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _f64(dtype) -> int:
    return int(dtype == torch.float64)


# ---------------------------------------------------------------------------
# stage
# ---------------------------------------------------------------------------

def _check_stage(m, mw, ax, bx, cx):
    if m.dim() != 2 or m.shape[0] < 1 or m.shape[1] < 1:
        raise ValueError(f"sharded_loo: components m [N, d], got "
                         f"{tuple(m.shape)}")
    nk, d = m.shape
    _want(mw=(mw, (nk,)), ax=(ax, (d,)), bx=(bx, (d,)), cx=(cx, (d,)))
    _dtype(m, mw, ax, bx, cx)
    return _device(m, mw, ax, bx, cx)


def _new_state(m, d):
    return (torch.empty((2, 8, d), dtype=m.dtype, device=m.device),
            torch.zeros((2, d), dtype=torch.int32, device=m.device))


def stage_ref(m, mw, ax, bx, cx):
    """Plain twin of :func:`stage`."""
    nk, d = m.shape
    n_pad = n_padded(nk)
    xs = torch.full((d, n_pad), math.inf, dtype=m.dtype, device=m.device)
    xs[:, :nk] = torch.where(mw[None, :] > 0, m.T,
                             torch.full_like(m.T, math.inf))
    wp = torch.zeros(n_pad, dtype=m.dtype, device=m.device)
    wp[:nk] = mw
    st, fl = _new_state(m, d)
    x1, x2 = golden_start(ax, bx, cx)
    st[0, X0], st[0, X3], st[0, X1], st[0, X2] = ax, cx, x1, x2
    st[0, PR0], st[0, PR1] = x1, x2
    st[0, F1:F2 + 1] = math.nan
    fl[0].fill_(2)
    return xs, wp, st, fl


def stage(m, mw, ax, bx, cx):
    """The components ``m [N, d]`` (weights ``mw``) staged per dimension,
    ``xs [d, n_pad]`` (``+inf`` for a zero weight or padding) and ``wp
    [n_pad]``, and the golden state for sweep 0, buffer 0 of ``st [2, 8,
    d]`` and ``fl [2, d]``, from the bracket ``ax < bx < cx`` ``[d]`` (x1
    and x2 as ``_golden_core`` places them; both rows of sweep 0
    active)."""
    dev = _check_stage(m, mw, ax, bx, cx)
    if not _on_kernel(dev):
        return stage_ref(m, mw, ax, bx, cx)
    nk, d = m.shape
    n_pad = n_padded(nk)
    m, mw, ax, bx, cx = (t.contiguous() for t in (m, mw, ax, bx, cx))
    xs = torch.empty((d, n_pad), dtype=m.dtype, device=dev)
    wp = torch.empty(n_pad, dtype=m.dtype, device=dev)
    st, fl = _new_state(m, d)
    with torch.cuda.device(dev):
        rc = _load().kde_k7_stage(
            m.data_ptr(), mw.data_ptr(), ax.data_ptr(), bx.data_ptr(),
            cx.data_ptr(), xs.data_ptr(), wp.data_ptr(), st.data_ptr(),
            fl.data_ptr(), nk, n_pad, d, _C, _f64(m.dtype), _stream(dev))
    _rc("stage", rc)
    return xs, wp, st, fl


# ---------------------------------------------------------------------------
# nn_shift
# ---------------------------------------------------------------------------

def _check_rows(q, xs, wp):
    if q.dim() != 2 or xs.dim() != 2 or q.shape[0] < 1:
        raise ValueError(f"sharded_loo: queries q [mq, d] and staged xs "
                         f"[d, n_pad], got {tuple(q.shape)}, "
                         f"{tuple(xs.shape)}")
    mq, d = q.shape
    n_pad = xs.shape[1]
    if xs.shape[0] != d or n_pad < TILE or n_pad % TILE:
        raise ValueError(f"sharded_loo: staged xs [{d}, whole tiles of "
                         f"{TILE}], got {tuple(xs.shape)}")
    _want(wp=(wp, (n_pad,)))
    return mq, d, n_pad


def _chunks(mq, n_pad):
    step = max(1, TWIN_CHUNK_ELEMS // n_pad)
    return [(a, min(mq, a + step)) for a in range(0, mq, step)]


def _diag(a, b, n_pad, q0, dev):
    """``[b - a, n_pad]``: query ``q0 + i`` is column ``q0 + i``."""
    rows = torch.arange(q0 + a, q0 + b, device=dev)
    cols = torch.arange(n_pad, device=dev)
    return rows[:, None] == cols[None, :]


def nn_shift_ref(q, xs, wp, q0: int = 0):
    """Plain twin of :func:`nn_shift`."""
    mq, d, n_pad = _check_rows(q, xs, wp)
    out = torch.empty((d, mq), dtype=q.dtype, device=q.device)
    for a, b in _chunks(mq, n_pad):
        diag = _diag(a, b, n_pad, q0, q.device)
        for k in range(d):
            delta = q[a:b, k, None] - xs[k][None, :]
            d2 = (delta * delta).masked_fill(diag, math.inf)
            out[k, a:b] = d2.min(dim=1).values
    return out


def nn_shift(q, xs, wp, q0: int = 0):
    """Each query's (``q [mq, d]``, global rows ``q0 + i``) least squared
    distance to a live staged column ``j`` other than itself, ``[d, mq]``;
    ``+inf`` where it has none."""
    mq, d, n_pad = _check_rows(q, xs, wp)
    _dtype(q, xs, wp)
    dev = _device(q, xs, wp)
    if q0 < 0:
        raise ValueError(f"sharded_loo: q0 {q0} < 0")
    if not _on_kernel(dev):
        return nn_shift_ref(q, xs, wp, q0)
    q, xs, wp = (t.contiguous() for t in (q, xs, wp))
    out = torch.empty((d, mq), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _load().kde_k7_nn_shift(
            q.data_ptr(), xs.data_ptr(), wp.data_ptr(), int(q0), mq, n_pad,
            d, out.data_ptr(), _f64(q.dtype), _stream(dev))
    _rc("nn_shift", rc)
    return out


# ---------------------------------------------------------------------------
# sweeps: a search's buffers; sweep, one launch a sweep
# ---------------------------------------------------------------------------

class Sweeps:
    """The buffers and launch arguments of one search's sweeps (made by
    :func:`sweeps`): the inputs, the state ``st`` / ``fl``, ``ent [iters +
    1, 2d, 2]`` (float64; ``ent_v[s]`` sweep s's rows), the picks
    ``xmin``, the flags (``flags`` on the device, ``flag_v[s]`` the one
    sweep s writes; ``host_flags`` its pinned copy) and, on the card, the
    plans, the scratch and the packed launch arguments."""


class _Rows:
    """``rows[s]``: row ``s`` of a tensor cut to ``width(s)``, a view made
    where it is asked for."""

    def __init__(self, t: torch.Tensor, width):
        self.t, self.width = t, width

    def __getitem__(self, s: int) -> torch.Tensor:
        return self.t[s, :self.width(s)]


class _Search(ctypes.Structure):
    """csrc/sharded_loo.cu's K7Search."""
    _fields_ = ([(k, ctypes.c_void_p) for k in (
        "q", "qw", "xs", "wp", "shift", "base", "st", "fl", "ent", "xmin",
        "trace", "flags", "part", "hb", "ctr", "stream")]
        + [("q0", ctypes.c_longlong)]
        + [(k, ctypes.c_double) for k in ("tol", "gc", "gr")]
        + [(k, ctypes.c_int) for k in (
            "mq", "n_pad", "d", "max_iters", "tiles0", "tiles1", "f64",
            "reserved")])


def _check_trace(trace, d, iters, dtype):
    if trace is not None and (tuple(trace.shape) != (d, iters + 2, 2)
                              or trace.dtype != dtype
                              or not trace.is_contiguous()):
        raise ValueError("sharded_loo: the trace must be new_trace's, "
                         "contiguous")


def _check_state(st, fl, d):
    _want(st=(st, (2, 8, d)), fl=(fl, (2, d)))
    if (fl.dtype != torch.int32 or not st.is_contiguous()
            or not fl.is_contiguous()):
        raise ValueError("sharded_loo: the state st [2, 8, d] and int32 fl "
                         "[2, d], contiguous, as stage makes them")


def sweeps(q, qw, xs, wp, shift, base, st, fl, *, q0: int = 0,
           tol: float = 1e-2, trace: Optional[torch.Tensor] = None) -> Sweeps:
    """A search's sweep buffers over the rank's queries ``q [mq, d]``
    (``qw``, global rows ``q0 + i``), the staged columns ``xs``, ``wp``,
    the shifts ``shift [d, mq]``, the base ``[d]`` and the state of
    :func:`stage`; every check and allocation of the search's sweeps, once
    (launches go to the stream current here)."""
    mq, d, n_pad = _check_rows(q, xs, wp)
    _want(qw=(qw, (mq,)), shift=(shift, (d, mq)), base=(base, (d,)))
    _check_state(st, fl, d)
    dt = _dtype(q, qw, xs, wp, shift, base, st)
    dev = _device(q, qw, xs, wp, shift, base, st, fl, trace)
    if q0 < 0:
        raise ValueError(f"sharded_loo: q0 {q0} < 0")
    iters = max_iters(tol, dt)
    _check_trace(trace, d, iters, dt)
    on_card = dev.type == "cuda"
    sw = Sweeps()
    sw.q, sw.qw, sw.xs, sw.wp, sw.shift, sw.base = (
        t.contiguous() for t in (q, qw, xs, wp, shift, base))
    sw.st, sw.fl, sw.trace = st, fl, trace
    sw.q0, sw.tol, sw.iters, sw.d, sw.mq, sw.n_pad = (int(q0), float(tol),
                                                     iters, d, mq, n_pad)
    sw.dev, sw.on_card = dev, on_card
    sw.ent = torch.zeros((iters + 1, 2 * d, 2), dtype=torch.float64,
                         device=dev)
    sw.ent_v = _Rows(sw.ent, lambda s: n_rows(s, d))
    sw.xmin = torch.empty(d, dtype=dt, device=dev)
    sw.flags = torch.zeros(iters + 2, dtype=torch.int32, device=dev)
    sw.host_flags = (torch.zeros(iters + 2, dtype=torch.int32,
                                 pin_memory=True) if on_card else sw.flags)
    one = lambda s: 1                                          # noqa: E731
    sw.flag_v = _Rows(sw.flags[:, None], one)
    sw.host_flag_v = _Rows(sw.host_flags[:, None], one)
    if on_card:
        _launch_args(sw)
    return sw


def _launch_args(sw: Sweeps):
    """The plans, the scratch and the packed launch arguments."""
    lib = _load()
    d, dev, dt = sw.d, sw.dev, sw.q.dtype
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sw.plans = [sweep_plan(sw.mq, sw.n_pad, n_rows(s, d), sms)
                for s in (0, 1)]
    part = max(p.rows * p.groups * p.chunks * GROUP if p.chunks > 1 else 0
               for p in sw.plans)
    groups = sw.plans[0].groups
    sw.part = torch.empty(max(1, part), dtype=torch.float64, device=dev)
    sw.hb = torch.empty(2 * 2 * d * groups, dtype=torch.float64, device=dev)
    sw.ctr = torch.zeros(1 + 2 * d * groups, dtype=torch.int32, device=dev)
    sw.packed = _Search(
        *(t.data_ptr() for t in (sw.q, sw.qw, sw.xs, sw.wp, sw.shift,
                                 sw.base, sw.st, sw.fl, sw.ent, sw.xmin)),
        None if sw.trace is None else sw.trace.data_ptr(),
        sw.flags.data_ptr(),
        sw.part.data_ptr(), sw.hb.data_ptr(), sw.ctr.data_ptr(),
        _stream(dev), sw.q0, search_tol(sw.tol, dt), _C, _R, sw.mq,
        sw.n_pad, d, sw.iters, sw.plans[0].tiles, sw.plans[1].tiles,
        _f64(dt), 0)
    sw.ref = ctypes.addressof(sw.packed)
    sw.call = lib.kde_k7_sweep


def _probe(x, b, dtype):
    """``[rows]`` each row's variance (float64) at probe ``x`` with base
    ``b`` and its exponent scale ``nh`` (T, in the kernel's units: log2 for
    float32)."""
    var = ((x * x) * (b * b)).double()
    scale = _LOG2E if dtype == torch.float32 else 1.0
    return var, (-0.5 * scale / var).to(dtype), scale


def _usable(shift):
    return torch.where(torch.isinf(shift), torch.zeros_like(shift), shift)


def _next_active(st, sweep: int, tol: float, dtype) -> torch.Tensor:
    """``[d]`` bool: the active test of step ``sweep`` on a state buffer."""
    if sweep >= max_iters(tol, dtype):
        return torch.zeros(st.shape[1], dtype=torch.bool, device=st.device)
    return golden_active(st[X0], st[X1], st[X2], st[X3],
                         search_tol(tol, dtype))


def sweep_ref(sw: Sweeps, s: int):
    """Plain twin of :func:`sweep`."""
    d, dt = sw.d, sw.q.dtype
    if s == 0:
        on = _next_active(sw.st[0], 0, sw.tol, dt)
        sw.flag_v[0].copy_(on.any().int().reshape(1))
    else:
        golden_step_ref(sw.ent_v[s - 1], sw.base, sw.st, sw.fl, sw.xmin,
                        sw.flag_v[s], s - 1, sw.tol, sw.trace)
    st, fl = sw.st[s & 1], sw.fl[s & 1]
    rows = n_rows(s, d)
    x = torch.cat([st[PR0], st[PR1]]) if s == 0 else st[PR0]
    var, nh, scale = _probe(x, sw.base.repeat(rows // d), dt)
    on = (torch.ones(rows, dtype=torch.bool, device=sw.dev) if s == 0
          else (fl & 2) != 0)
    on_list = on.tolist()
    q, xs, wp, shift, qw = sw.q, sw.xs, sw.wp, sw.shift, sw.qw
    exp = torch.exp2 if dt == torch.float32 else torch.exp
    sums = torch.zeros((rows, sw.mq), dtype=torch.float64, device=sw.dev)
    for a, b in _chunks(sw.mq, sw.n_pad):
        diag = _diag(a, b, sw.n_pad, sw.q0, sw.dev)
        for r in range(rows):
            if not on_list[r]:
                continue
            k = r % d
            off = -(_usable(shift[k, a:b]) * nh[r])
            delta = q[a:b, k, None] - xs[k][None, :]
            terms = wp[None, :] * exp(delta * delta * nh[r] + off[:, None])
            sums[r, a:b] = terms.masked_fill(diag, 0.0).sum(
                dim=1, dtype=torch.float64)
    k = torch.arange(rows, device=sw.dev) % d
    off = -(_usable(shift)[k] * nh[:, None])                   # [rows, mq]
    wi = qw.double()[None, :]
    logp = (torch.log(sums) - off.double() / scale
            - 0.5 * torch.log(var)[:, None] - 0.5 * LOG_2PI
            - torch.log1p(-wi))
    pos = wi > 0
    zero = torch.zeros_like(logp)
    c = torch.where(pos, wi * torch.where(pos, logp, zero), zero).sum(dim=1)
    bad = (torch.isneginf(logp) & pos).double().sum(dim=1)
    ent = torch.stack([-c, bad], dim=1)
    sw.ent_v[s].copy_(torch.where(on[:, None], ent, torch.zeros_like(ent)))


def sweep(sw: Sweeps, s: int):
    """Sweep ``s`` of the search ``sw`` in one launch.  Its head applies
    the golden step of sweep ``s - 1`` from ``sw.ent_v[s - 1]`` (all-reduced
    by then): state buffer ``(s - 1) & 1 -> s & 1``, the picks, the trace,
    and ``flag_v[s]``, the active test of step ``s`` (1 while sweep ``s +
    1`` has a row to search).  Its body writes ``sw.ent_v[s]`` (float64
    ``[rows, 2]``, rows = 2d at s = 0: x1 of every dimension, then x2; d
    after): per searching row ``h = -sum_{i: w_i > 0} w_i log p_i`` over
    the rank's queries and ``bad``, the count of positive-weight queries
    with ``p = 0``, where ``log p_i = log S_i - shift_i / (2 var) -
    log(var) / 2 - log(2 pi) / 2 - log1p(-w_i)`` and ``S_i = sum_{j != i}
    w_j exp(-(d2_ij - shift_i) / (2 var))`` over every column, ``var = (x
    x)(b b)``; frozen rows give (0, 0).  The search takes its psum over
    every rank."""
    if not _on_kernel(sw.dev):
        return sweep_ref(sw, s)
    _rc("sweep", sw.call(sw.ref, s))


# ---------------------------------------------------------------------------
# golden_step
# ---------------------------------------------------------------------------

def golden_step_ref(ent, base, st, fl, xmin, flag, sweep: int, tol: float,
                    trace=None):
    """Plain twin of :func:`golden_step`: ``_golden_core``'s arithmetic
    (``loo_search.golden_*``), one iteration a call."""
    d = base.shape[0]
    dt = base.dtype
    n_iters = max_iters(tol, dt)
    stol = search_tol(tol, dt)
    f = torch.where(ent[:, 1] > 0, torch.full_like(ent[:, 0], math.inf),
                    ent[:, 0]).to(dt)
    b_in, b_out = st[sweep & 1], st[(sweep + 1) & 1]
    x0, x1, x2, x3 = b_in[X0], b_in[X1], b_in[X2], b_in[X3]
    f1, f2, pr0, pr1 = b_in[F1], b_in[F2], b_in[PR0], b_in[PR1]
    was_fl = fl[sweep & 1]
    if sweep == 0:
        f1, f2 = f[:d], f[d:]
        if trace is not None:
            trace[:, 0] = torch.stack([x1, f1], 1)
            trace[:, 1] = torch.stack([x2, f2], 1)
    else:
        was = (was_fl & 2) != 0
        take2, take1 = was & ((was_fl & 1) != 0), was & ((was_fl & 1) == 0)
        if trace is not None:
            trace[:, 1 + sweep] = torch.where(
                was[:, None], torch.stack([pr0, f], 1), trace[:, 1 + sweep])
        f1, f2 = golden_fold(f1, f2, f, take2, take1)
    active = golden_active(x0, x1, x2, x3, stol)
    if sweep >= n_iters:
        active = torch.zeros_like(active)
    (nx0, nx1, nx2, nx3), take2, _, probe = golden_update(
        x0, x1, x2, x3, f1, f2, active)
    b_out.copy_(torch.stack([nx0, nx1, nx2, nx3, f1, f2,
                             torch.where(active, probe, pr0), pr1]))
    fl[(sweep + 1) & 1].copy_(take2.int() | (active.int() << 1))
    xmin.copy_(torch.where(f1 < f2, nx1, nx2) * base)
    nxt = _next_active(b_out, sweep + 1, tol, dt)
    flag.copy_(nxt.any().int().reshape(1))


def golden_step(ent, base, st, fl, xmin, flag, sweep: int, tol: float,
                trace=None):
    """The golden step after sweep ``sweep`` from its all-reduced ``ent``:
    each row takes its objective (``+inf`` where ``bad > 0``), then
    ``_golden_core``'s iteration ``sweep`` (the active test, at most
    ``max_iters``; the masked bracket update; the next probe) takes the
    state from buffer ``sweep & 1`` of ``st``, ``fl`` to buffer ``(sweep +
    1) & 1``, writes the picks ``xmin [d]`` (x times ``base``) and ``flag
    [1]`` (int32: 1 while the next step has a row to search); ``trace``
    (:func:`loo_search.new_trace` of ``[d]`` rows) receives each probe."""
    d = base.shape[0]
    _want(ent=(ent, (n_rows(sweep, d), 2)), xmin=(xmin, (d,)),
          flag=(flag, (1,)))
    _check_state(st, fl, d)
    if sweep < 0:
        raise ValueError(f"sharded_loo: sweep {sweep} >= 0")
    _dtype(base, st, xmin)
    if ent.dtype != torch.float64 or flag.dtype != torch.int32:
        raise TypeError("sharded_loo: float64 ent and int32 flag")
    dev = _device(ent, base, st, fl, xmin, flag, trace)
    iters = max_iters(tol, base.dtype)
    _check_trace(trace, d, iters, base.dtype)
    if not _on_kernel(dev):
        return golden_step_ref(ent, base, st, fl, xmin, flag, sweep, tol,
                               trace)
    ent, base = ent.contiguous(), base.contiguous()
    with torch.cuda.device(dev):
        rc = _load().kde_k7_golden_step(
            ent.data_ptr(), base.data_ptr(), st.data_ptr(), fl.data_ptr(),
            xmin.data_ptr(), None if trace is None else trace.data_ptr(),
            flag.data_ptr(), int(sweep), d, iters,
            search_tol(float(tol), base.dtype), _C, _R, _f64(base.dtype),
            _stream(dev))
    _rc("golden_step", rc)


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _read_flag(flags: torch.Tensor, events: list, k: int) -> int:
    """The active flag of sweep ``k``, once that sweep's event has passed
    (a wait on a sweep the card finished or is finishing, never on the one
    just issued)."""
    if events[k] is not None:
        events[k].synchronize()
    return int(flags[k])


def search(q, qw, m, mw, base, ax, bx, cx, *, q0: int = 0,
           tol: float = 1e-2,
           psum: Callable[[torch.Tensor], torch.Tensor] = _same,
           trace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The golden search of every dimension's LOO entropy over the rank's
    queries ``q [mq, d]`` (``qw``, global rows ``q0 + i``) and all the
    components ``m [N, d]`` (``mw``), variance ``x^2 base^2``, from the
    bracket ``ax < bx < cx`` ``[d]``: the selected std-dev bandwidths ``x
    base`` ``[d]``.  ``psum`` sums a sweep's ``[rows, 2]`` over every rank
    (the identity: one rank holds every query), in place or into a
    tensor it returns.  Every rank must pass the same bracket and
    components; the stop rule reads only collective results, so every rank
    issues the same collectives.  Counts go to :data:`LAST`."""
    global LAST
    dev = _device(q, qw, m, mw, base, ax, bx, cx)
    _dtype(q, qw, m, mw, base, ax, bx, cx)
    d = base.shape[0]
    _want(q=(q, (q.shape[0], d)), qw=(qw, (q.shape[0],)),
          m=(m, (m.shape[0], d)))
    xs, wp, st, fl = stage(m, mw, ax, bx, cx)
    shift = nn_shift(q, xs, wp, q0)
    sw = sweeps(q, qw, xs, wp, shift, base, st, fl, q0=q0, tol=tol,
                trace=trace)
    with (torch.cuda.device(dev) if dev.type == "cuda"
          else contextlib.nullcontext()):
        s, stop, waits = _sweep_loop(sw, psum)
    golden_step(sw.ent_v[s], base, st, fl, sw.xmin, sw.flags[s + 1:s + 2],
                s, tol, trace)
    LAST = dict(sweeps=s + 1, host_waits=waits, stop=stop)
    return sw.xmin


def _sweep_loop(sw: Sweeps, psum):
    """Issue sweeps until a flag read FLAG_LAG sweeps late is 0 or
    max_iters ends them: the last sweep, the stop reason and the reads.
    A sweep's event is one of a ring of FLAG_LAG + 1, recorded anew."""
    ring = ([torch.cuda.Event() for _ in range(FLAG_LAG + 1)]
            if sw.on_card else [None])
    events, waits, s = [], 0, 0
    while True:
        sweep(sw, s)
        ev = ring[s % len(ring)]
        if ev is not None:
            sw.host_flag_v[s].copy_(sw.flag_v[s], non_blocking=True)
            ev.record()
        events.append(ev)
        ent = sw.ent_v[s]
        got = psum(ent)
        if got is not ent:
            ent.copy_(got)
        if s >= sw.iters:
            return s, "max_iters", waits
        if s >= FLAG_LAG:
            waits += 1
            if not _read_flag(sw.host_flags, events, s - FLAG_LAG):
                return s, "flag", waits
        s += 1
