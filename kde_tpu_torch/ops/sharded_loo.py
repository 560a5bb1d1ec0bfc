"""The local work of the sharded LOOCV golden search, between its
collectives (the port's K7; on the TPU the inline ``jnp`` probe of
``kde_tpu/parallel/eval.py::ksize_bandwidths_sharded`` :151-191, XLA-fused
in its ``shard_map`` program around the ``lax.while_loop`` of
``kde_tpu/ops/loocv.py:180``).

A rank holds the queries ``q [mq, d]`` (weights ``qw``) of its chains
shard, global rows ``q0 + i``, and the components ``m [nk, d]`` (weights
``mw``) of its kernels shard, global columns ``k0 + j``; the weights of the
whole problem sum to 1.  :func:`search` runs the golden search of every
dimension at once (``ops/loo_search.py::_golden_core``'s trajectory) as::

    xs, wp, st, fl = stage(m, mw, ax, bx, cx)
    shift = nn_shift(q, xs, wp, q0, k0)                    -> pmin
    for each sweep s:
        sums = probe_sums(q, xs, wp, shift, base, st, fl, s, q0, k0)
                                                           -> psum kernels
        ent = probe_entropy(sums, shift, qw, base, st, fl, s)
                                                           -> psum chains
        golden_step(ent, base, st, fl, xmin, flag, s, tol)

so a search calls ``1 + 2 * sweeps`` collectives (on a mesh that lacks an
axis, that axis's calls issue nothing).  ``shift`` is each query's least
squared distance to a live neighbour (``+inf`` where it has none), which
does not depend on the probe: every term of a sum is at most its weight.  The golden state lives in ``st [8, d]`` (x0, x1, x2, x3, f1,
f2 and the probes pr0, pr1) and ``fl [d]`` (bit 0 take2, bit 1 active) on
the tensors' device, so the host never reads the sweep it has just
issued: it reads the active flag of the sweep ``FLAG_LAG`` back, from
pinned memory after that sweep's event, and stops when it is 0; the
sweeps issued meanwhile change nothing (frozen rows take no work).

CUDA tensors launch the hand-written kernels of ``csrc/sharded_loo.cu``
(built with nvcc ``--fmad=false`` into ``_build/`` at the first launch;
the probe arithmetic is ``csrc/loo_probe.cuh``, K4's); no phase builds an
``[mq, nk]`` tensor on the card.  CPU tensors take each phase's plain twin
``*_ref``, eager torch over query chunks, with the same signature (each
counted in ``TWIN_STAGES``).  A failed build, a refused launch or an input
the kernels do not take raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import math
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
# Phases that ran on the twins (CPU tensors).
TWIN_STAGES = 0
# The host reads the active flag of the sweep this many sweeps back.
FLAG_LAG = 1
# The last search's counts: sweeps, host_waits (lagged flag reads) and
# stop ("flag": a flag read was 0; "max_iters": the bound ended it).
LAST: dict = {}

TILE = 1024                 # csrc/loo_probe.cuh's kTile: staged columns
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
        lib.kde_k7_nn_shift.argtypes = [vp] * 3 + [ll] * 2 + [i] * 3 + [
            vp, i, vp]
        lib.kde_k7_probe_sums.argtypes = [vp] * 7 + [i, ll, ll] + [i] * 3 + [
            vp, i, vp]
        lib.kde_k7_probe_entropy.argtypes = [vp] * 6 + [i] * 3 + [vp, i, vp]
        lib.kde_k7_golden_step.argtypes = [vp] * 7 + [i] * 3 + [f] * 3 + [
            i, vp]
        for fn in (lib.kde_k7_stage, lib.kde_k7_nn_shift,
                   lib.kde_k7_probe_sums, lib.kde_k7_probe_entropy,
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


# ---------------------------------------------------------------------------
# stage
# ---------------------------------------------------------------------------

def _check_stage(m, mw, ax, bx, cx):
    if m.dim() != 2 or m.shape[0] < 1 or m.shape[1] < 1:
        raise ValueError(f"sharded_loo: components m [nk, d], got "
                         f"{tuple(m.shape)}")
    nk, d = m.shape
    _want(mw=(mw, (nk,)), ax=(ax, (d,)), bx=(bx, (d,)), cx=(cx, (d,)))
    _dtype(m, mw, ax, bx, cx)
    return _device(m, mw, ax, bx, cx)


def _new_state(m, d):
    return (torch.empty((8, d), dtype=m.dtype, device=m.device),
            torch.empty(d, dtype=torch.int32, device=m.device))


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
    st[X0], st[X3], st[X1], st[X2] = ax, cx, x1, x2
    st[PR0], st[PR1] = x1, x2
    st[F1:F2 + 1] = math.nan
    fl.fill_(2)
    return xs, wp, st, fl


def stage(m, mw, ax, bx, cx):
    """The shard's components ``m [nk, d]`` (weights ``mw``) staged per
    dimension, ``xs [d, n_pad]`` (``+inf`` for a zero weight or padding)
    and ``wp [n_pad]``, and the golden state ``st [8, d]``, ``fl [d]`` from
    the bracket ``ax < bx < cx`` ``[d]`` (x1 and x2 as ``_golden_core``
    places them; both rows of sweep 0 active)."""
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
            fl.data_ptr(), nk, n_pad, d, _C,
            int(m.dtype == torch.float64), _stream(dev))
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


def _diag(a, b, n_pad, q0, k0, dev):
    """``[b - a, n_pad]``: query ``q0 + i`` is column ``k0 + j``."""
    rows = torch.arange(q0 + a, q0 + b, device=dev)
    cols = torch.arange(k0, k0 + n_pad, device=dev)
    return rows[:, None] == cols[None, :]


def nn_shift_ref(q, xs, wp, q0: int = 0, k0: int = 0):
    """Plain twin of :func:`nn_shift`."""
    mq, d, n_pad = _check_rows(q, xs, wp)
    out = torch.empty((d, mq), dtype=q.dtype, device=q.device)
    for a, b in _chunks(mq, n_pad):
        diag = _diag(a, b, n_pad, q0, k0, q.device)
        for k in range(d):
            delta = q[a:b, k, None] - xs[k][None, :]
            d2 = (delta * delta).masked_fill(diag, math.inf)
            out[k, a:b] = d2.min(dim=1).values
    return out


def nn_shift(q, xs, wp, q0: int = 0, k0: int = 0):
    """Each query's (``q [mq, d]``, global rows ``q0 + i``) least squared
    distance to a live staged column ``j`` (global ``k0 + j``) other than
    itself, ``[d, mq]``; ``+inf`` where this shard holds none.  The search
    takes its ``pmin`` over the kernels axis."""
    mq, d, n_pad = _check_rows(q, xs, wp)
    _dtype(q, xs, wp)
    dev = _device(q, xs, wp)
    if not _on_kernel(dev):
        return nn_shift_ref(q, xs, wp, q0, k0)
    q, xs, wp = (t.contiguous() for t in (q, xs, wp))
    out = torch.empty((d, mq), dtype=q.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = _load().kde_k7_nn_shift(
            q.data_ptr(), xs.data_ptr(), wp.data_ptr(), int(q0), int(k0), mq,
            n_pad, d, out.data_ptr(), int(q.dtype == torch.float64),
            _stream(dev))
    _rc("nn_shift", rc)
    return out


# ---------------------------------------------------------------------------
# probe_sums, probe_entropy
# ---------------------------------------------------------------------------

def _probe(st, base, sweep, dtype):
    """``[rows]`` each row's variance (float64) and exponent scale ``nh``
    (T, in the kernel's units: log2 for float32) and the dimension it
    belongs to."""
    d = base.shape[0]
    rows = n_rows(sweep, d)
    x = torch.cat([st[PR0], st[PR1]]) if sweep == 0 else st[PR0]
    b = base.repeat(rows // d)
    var = ((x * x) * (b * b)).double()
    scale = _LOG2E if dtype == torch.float32 else 1.0
    return var, (-0.5 * scale / var).to(dtype), scale


def _searching(fl, sweep, d):
    """``[rows]`` bool: the rows a sweep covers."""
    if sweep == 0:
        return torch.ones(2 * d, dtype=torch.bool, device=fl.device)
    return (fl & 2) != 0


def _usable(shift):
    return torch.where(torch.isinf(shift), torch.zeros_like(shift), shift)


def _check_sweep(st, fl, base, sweep, d):
    _want(st=(st, (8, d)), fl=(fl, (d,)), base=(base, (d,)))
    if sweep < 0 or fl.dtype != torch.int32:
        raise ValueError(f"sharded_loo: sweep {sweep} >= 0 and int32 fl, got "
                         f"{fl.dtype}")


def probe_sums_ref(q, xs, wp, shift, base, st, fl, sweep: int,
                   q0: int = 0, k0: int = 0):
    """Plain twin of :func:`probe_sums` (frozen rows 0)."""
    mq, d, n_pad = _check_rows(q, xs, wp)
    rows = n_rows(sweep, d)
    var, nh, scale = _probe(st, base, sweep, q.dtype)
    on = _searching(fl, sweep, d).tolist()
    out = torch.zeros((rows, mq), dtype=torch.float64, device=q.device)
    exp = torch.exp2 if q.dtype == torch.float32 else torch.exp
    for a, b in _chunks(mq, n_pad):
        diag = _diag(a, b, n_pad, q0, k0, q.device)
        for r in range(rows):
            if not on[r]:
                continue
            k = r % d
            off = -(_usable(shift[k, a:b]) * nh[r])
            delta = q[a:b, k, None] - xs[k][None, :]
            terms = wp[None, :] * exp(delta * delta * nh[r] + off[:, None])
            out[r, a:b] = terms.masked_fill(diag, 0.0).sum(
                dim=1, dtype=torch.float64)
    return out


def probe_sums(q, xs, wp, shift, base, st, fl, sweep: int, q0: int = 0,
               k0: int = 0):
    """Sweep ``sweep``'s shifted sums ``[rows, mq]`` (float64) of every
    searching row, ``rows`` = 2d at sweep 0 (x1 of every dimension, then
    x2), d after: ``sum_{j != i} w_j exp(-(d2_ij - shift_i) / (2 var))``
    over this shard's columns, ``var = (x x)(b b)``.  The kernels leave a
    frozen row's values undefined; the search takes their ``psum`` over
    the kernels axis."""
    mq, d, n_pad = _check_rows(q, xs, wp)
    _want(shift=(shift, (d, mq)))
    _check_sweep(st, fl, base, sweep, d)
    _dtype(q, xs, wp, shift, base, st)
    dev = _device(q, xs, wp, shift, base, st, fl)
    if not _on_kernel(dev):
        return probe_sums_ref(q, xs, wp, shift, base, st, fl, sweep, q0, k0)
    q, xs, wp, shift, base = (t.contiguous() for t in (q, xs, wp, shift,
                                                      base))
    out = torch.empty((n_rows(sweep, d), mq), dtype=torch.float64,
                      device=dev)
    with torch.cuda.device(dev):
        rc = _load().kde_k7_probe_sums(
            q.data_ptr(), xs.data_ptr(), wp.data_ptr(), shift.data_ptr(),
            base.data_ptr(), st.data_ptr(), fl.data_ptr(), int(sweep),
            int(q0), int(k0), mq, n_pad, d, out.data_ptr(),
            int(q.dtype == torch.float64), _stream(dev))
    _rc("probe_sums", rc)
    return out


def probe_entropy_ref(sums, shift, qw, base, st, fl, sweep: int):
    """Plain twin of :func:`probe_entropy`."""
    d, mq = shift.shape
    rows = n_rows(sweep, d)
    var, nh, scale = _probe(st, base, sweep, shift.dtype)
    on = _searching(fl, sweep, d)
    k = torch.arange(rows, device=shift.device) % d
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
    return torch.where(on[:, None], ent, torch.zeros_like(ent))


def probe_entropy(sums, shift, qw, base, st, fl, sweep: int):
    """Sweep ``sweep``'s ``[rows, 2]`` (float64): per row ``h = -sum_{i:
    w_i > 0} w_i log p_i`` over this shard's queries (``qw [mq]``) and
    ``bad``, the count of positive-weight queries with ``p = 0``, from the
    kernels-summed ``sums``:  ``log p_i = log S_i - shift_i / (2 var) -
    log(var) / 2 - log(2 pi) / 2 - log1p(-w_i)``.  Frozen rows give (0,
    0).  The search takes its ``psum`` over the chains axis."""
    if shift.dim() != 2:
        raise ValueError(f"sharded_loo: shift [d, mq], got "
                         f"{tuple(shift.shape)}")
    d, mq = shift.shape
    _want(sums=(sums, (n_rows(sweep, d), mq)), qw=(qw, (mq,)))
    _check_sweep(st, fl, base, sweep, d)
    _dtype(shift, qw, base, st)
    if sums.dtype != torch.float64:
        raise TypeError(f"sharded_loo: float64 sums, got {sums.dtype}")
    dev = _device(sums, shift, qw, base, st, fl)
    if not _on_kernel(dev):
        return probe_entropy_ref(sums, shift, qw, base, st, fl, sweep)
    sums, shift, qw, base = (t.contiguous() for t in (sums, shift, qw,
                                                     base))
    out = torch.empty((n_rows(sweep, d), 2), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = _load().kde_k7_probe_entropy(
            sums.data_ptr(), shift.data_ptr(), qw.data_ptr(),
            base.data_ptr(), st.data_ptr(), fl.data_ptr(), int(sweep), mq, d,
            out.data_ptr(), int(shift.dtype == torch.float64), _stream(dev))
    _rc("probe_entropy", rc)
    return out


# ---------------------------------------------------------------------------
# golden_step
# ---------------------------------------------------------------------------

def golden_step_ref(ent, base, st, fl, xmin, flag, sweep: int, tol: float,
                    trace=None):
    """Plain twin of :func:`golden_step`: ``_golden_core``'s arithmetic
    (``loo_search.golden_*``), one iteration a call."""
    d = base.shape[0]
    n_iters = max_iters(tol, base.dtype)
    tol = search_tol(tol, base.dtype)
    f = torch.where(ent[:, 1] > 0, torch.full_like(ent[:, 0], math.inf),
                    ent[:, 0]).to(base.dtype)
    x0, x1, x2, x3 = st[X0], st[X1], st[X2], st[X3]
    f1, f2, pr0 = st[F1], st[F2], st[PR0]
    if sweep == 0:
        f1, f2 = f[:d], f[d:]
        if trace is not None:
            trace[:, 0] = torch.stack([x1, f1], 1)
            trace[:, 1] = torch.stack([x2, f2], 1)
    else:
        was = (fl & 2) != 0
        take2, take1 = was & ((fl & 1) != 0), was & ((fl & 1) == 0)
        if trace is not None:
            trace[:, 1 + sweep] = torch.where(
                was[:, None], torch.stack([pr0, f], 1), trace[:, 1 + sweep])
        f1, f2 = golden_fold(f1, f2, f, take2, take1)
    active = golden_active(x0, x1, x2, x3, tol)
    if sweep >= n_iters:
        active = torch.zeros_like(active)
    (nx0, nx1, nx2, nx3), take2, _, probe = golden_update(
        x0, x1, x2, x3, f1, f2, active)
    st[X0], st[X1], st[X2], st[X3] = nx0, nx1, nx2, nx3
    st[F1], st[F2] = f1, f2
    st[PR0] = torch.where(active, probe, pr0)
    fl.copy_(take2.int() | (active.int() << 1))
    xmin.copy_(torch.where(f1 < f2, nx1, nx2) * base)
    flag.copy_(active.any().int().reshape(1))


def _check_trace(trace, d, iters, dtype):
    if trace is not None and (tuple(trace.shape) != (d, iters + 2, 2)
                              or trace.dtype != dtype
                              or not trace.is_contiguous()):
        raise ValueError("sharded_loo: the trace must be new_trace's, "
                         "contiguous")


def golden_step(ent, base, st, fl, xmin, flag, sweep: int, tol: float,
                trace=None):
    """The golden step after sweep ``sweep`` from its chains-summed
    ``ent``: each row takes its objective (``+inf`` where ``bad > 0``),
    then ``_golden_core``'s iteration ``sweep`` (the active test, at most
    ``max_iters``; the masked bracket update; the next probe) updates
    ``st``, ``fl``, the picks ``xmin [d]`` (x times ``base``) and
    ``flag [1]`` (int32: 1 while a row searches), in place; ``trace``
    (:func:`loo_search.new_trace` of ``[d]`` rows) receives each probe."""
    d = base.shape[0]
    _want(ent=(ent, (n_rows(sweep, d), 2)), xmin=(xmin, (d,)),
          flag=(flag, (1,)))
    _check_sweep(st, fl, base, sweep, d)
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
            search_tol(float(tol), base.dtype), _C, _R,
            int(base.dtype == torch.float64), _stream(dev))
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


def search(q, qw, m, mw, base, ax, bx, cx, *, q0: int = 0, k0: int = 0,
           tol: float = 1e-2,
           pmin: Callable[[torch.Tensor], torch.Tensor] = _same,
           psum_kernels: Callable[[torch.Tensor], torch.Tensor] = _same,
           psum_chains: Callable[[torch.Tensor], torch.Tensor] = _same,
           trace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The golden search of every dimension's LOO entropy over the shard's
    queries ``q [mq, d]`` (``qw``, global rows ``q0 + i``) and components
    ``m [nk, d]`` (``mw``, global columns ``k0 + j``), variance ``x^2
    base^2``, from the bracket ``ax < bx < cx`` ``[d]``: the selected
    std-dev bandwidths ``x base`` ``[d]``.  ``pmin`` reduces over the
    kernels axis, ``psum_kernels`` and ``psum_chains`` sum over theirs (the
    identity: one shard holds the whole problem).  Every rank must pass
    the same bracket; the stop rule reads only collective results, so every
    rank issues the same collectives.  Counts go to :data:`LAST`."""
    global LAST
    dev = _device(q, qw, m, mw, base, ax, bx, cx)
    dt = _dtype(q, qw, m, mw, base, ax, bx, cx)
    d = base.shape[0]
    _want(q=(q, (q.shape[0], d)), qw=(qw, (q.shape[0],)),
          m=(m, (m.shape[0], d)))
    iters = max_iters(tol, dt)
    on_card = dev.type == "cuda"
    xs, wp, st, fl = stage(m, mw, ax, bx, cx)
    shift = pmin(nn_shift(q, xs, wp, q0, k0))
    xmin = torch.empty(d, dtype=dt, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    flags = torch.zeros(iters + 2, dtype=torch.int32, pin_memory=on_card)
    events, waits = [], 0
    sweep, stop = 0, "max_iters"
    while True:
        sums = psum_kernels(probe_sums(q, xs, wp, shift, base, st, fl, sweep,
                                       q0, k0))
        ent = psum_chains(probe_entropy(sums, shift, qw, base, st, fl, sweep))
        golden_step(ent, base, st, fl, xmin, flag, sweep, tol, trace)
        flags[sweep:sweep + 1].copy_(flag, non_blocking=on_card)
        ev = None
        if on_card:
            ev = torch.cuda.Event()
            ev.record()
        events.append(ev)
        if sweep >= iters:
            break
        if sweep >= FLAG_LAG:
            waits += 1
            if not _read_flag(flags, events, sweep - FLAG_LAG):
                stop = "flag"
                break
        sweep += 1
    LAST = dict(sweeps=sweep + 1, host_waits=waits, stop=stop)
    return xmin
