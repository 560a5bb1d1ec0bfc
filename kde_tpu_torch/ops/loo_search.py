"""The LOOCV golden-section search of ``R`` independent 1-D rows in one
launch (the port's K4; on the TPU ``kde_tpu/ops/loocv.py::_ksize_search``,
one jitted ``lax.while_loop`` around the probe, the Pallas kernel K1 above
``LOOCV_PAIR_LIMIT``).

:func:`loo_search` returns the minimizing ``x`` of every row's search over
the LOO entropy with variance ``base_var * x^2``, from the bracket
``ax < bx < cx``.  CUDA tensors launch the hand-written kernel
``csrc/loo_search.cu`` once, with no host read: the probes, the loop and
its stop rule all stay on the card, on one of the kernel's two plans,
chosen by :func:`launch_plan` from the shape before the launch: rows that
fit a block's shared memory take the rows plan (each block keeps its row
resident, a row's blocks meet at a barrier of their own), others the grid
plan (one cooperative grid, a grid-wide sync a sweep).  Both give the same
bits.  CPU tensors take the plain twin
:func:`loo_search_ref`, the eager golden loop :func:`_golden_core` over the
probe route ``impl`` (``dense``, ``chunk`` or ``tiled``, as
``ops/loocv.py::select_loo_impl`` picks it; on the card the route only
says what the twin would do).  The library is built with nvcc
(``--fmad=false``) into ``_build/`` at the first launch; a failed build, a
refused launch (a grid that cannot be co-resident included) or an input
the kernel does not take raises, and nothing falls back.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from .kernels import (batched_loo_entropy, loo_entropy_given_d2,
                      loo_pairwise_d2)
from .tiled_eval import _sm_count, nvcc_build

_C = (3.0 - math.sqrt(5.0)) / 2.0   # golden-section constants
_R = 1.0 - _C                       # (reference src/CrossValidation.jl:51-52)

# Launches of the CUDA kernel; a run sets it to 0 and reads it to show the
# path went through the kernel.  ROWS_LAUNCHES: those on the rows plan.
LAUNCHES = 0
ROWS_LAUNCHES = 0

# The most rows one launch takes: every block keeps each row's search state
# in shared memory (csrc/loo_search.cu's kMaxRows).  More rows take a
# launch for each MAX_ROWS of them.
MAX_ROWS = 1024

# The kernel's work item: a group of GROUP queries (csrc/loo_probe.cuh's
# kGroup).
GROUP = 32
# The rows plan (csrc/loo_search.cu's loo_rows_kernel): a row's blocks
# meet on a thread-block cluster of at most ROWS_MAX_CLUSTER blocks
# (kMaxCluster, the portable size), else at a per-row counter; a block is
# up to ROWS_MAX_TEAMS teams of 256 threads (kMaxTeams), each taking a
# group at a time, and holds its row, the weights and its queries'
# constants in at most ROWS_SMEM bytes of shared memory (kRowsSmemMax).
# Rows of more points than ROWS_MAX_N gives their type take the grid plan:
# the crossover of `chip_smoke.py --k4-diag`'s sweep over 1, 2, 3 and 12
# rows of 256 to 16,384 points on an H100 (PERF.md), where the rows plan
# read 0.31-0.93 of the grid plan's time at every float32 shape and
# 0.27-0.99 in float64 up to 2,048 points (1.03-1.18 from 4,096 at three
# rows or more and from 8,192 at any: sixteen warps an SM hide the FP64
# exp's latency less well than the grid plan's twenty-four).
ROWS_MAX_CLUSTER = 8
ROWS_MAX_TEAMS = 2
ROWS_SMEM = 232448 - 2048
ROWS_MAX_N = {torch.float32: 16384, torch.float64: 2048}


class Plan(NamedTuple):
    """A launch's plan: ``layout`` "rows" (``blocks_per_row`` blocks a row,
    ``groups_per_block`` query groups a block, ``teams`` teams of 256
    threads a block, on a cluster or meeting at a per-row counter, ``smem``
    bytes of dynamic shared memory a block) or "grid" (its blocks the
    library's occupancy query's)."""
    layout: str
    blocks_per_row: int = 0
    groups_per_block: int = 0
    teams: int = 0
    cluster: bool = False
    smem: int = 0


GRID = Plan("grid")


def n_groups(n: int) -> int:
    return -(-n // GROUP)


def rows_smem(n: int, gpb: int, itemsize: int) -> int:
    """Dynamic shared memory of a rows-plan block (``rows_smem_bytes``):
    its groups' sums [2][2][gpb] and its queries' log1p(-w) in float64, the
    staged row and weights (``n`` rounded up to whole 16-byte vectors) and
    its queries' shifts and x."""
    return ((4 + GROUP) * gpb * 8
            + (2 * (-(-n // 4) * 4) + 2 * gpb * GROUP) * itemsize)


@functools.lru_cache(maxsize=1024)
def launch_plan(r: int, n: int, dtype, sms: int,
                smem: int = ROWS_SMEM) -> Plan:
    """The plan of one launch of ``r`` rows of ``n`` points of ``dtype`` on
    a card of ``sms`` SMs whose blocks may use ``smem`` bytes of shared
    memory: :func:`_rows_plan` for rows of 1 to ``ROWS_MAX_N[dtype]``
    points, else the grid plan."""
    if not 1 <= n <= ROWS_MAX_N[dtype]:
        return GRID
    return _rows_plan(r, n, dtype, sms, smem)


def _rows_plan(r: int, n: int, dtype, sms: int,
               smem: int = ROWS_SMEM) -> Plan:
    """The rows plan of ``r`` rows of ``n >= 1`` points where its block
    fits in ``smem`` bytes, else the grid plan: a sweep's ``r *
    n_groups(n)`` query groups spread evenly over about one block an SM
    (``groups_per_block`` of them, the row's ``blocks_per_row`` blocks each
    a contiguous run, two teams where a block has two groups or more), a
    row's blocks on one cluster where they are at most ROWS_MAX_CLUSTER,
    else at most ``sms`` blocks in all, so that a cooperative launch holds
    them at once."""
    itemsize = 8 if dtype == torch.float64 else 4
    g = n_groups(n)
    gpb = max(1, -(-r * g // sms))
    b = -(-g // gpb)
    while b > ROWS_MAX_CLUSTER and r * b > sms:
        gpb += 1
        b = -(-g // gpb)
    gpb = -(-g // b)
    b = -(-g // gpb)
    need = rows_smem(n, gpb, itemsize)
    if need > smem:
        return GRID
    return Plan("rows", b, gpb, min(ROWS_MAX_TEAMS, gpb),
                b <= ROWS_MAX_CLUSTER, need)


SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "loo_search.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lib = None
BUILD_LOG = ""


def build() -> Path:
    """Compile ``csrc/loo_search.cu`` (once per source and flags) and return
    the shared library's path; a failed build raises."""
    global BUILD_LOG
    out, log = nvcc_build(SOURCE, NVCC_FLAGS, "loo_search")
    BUILD_LOG = log or BUILD_LOG
    return out


def bind(path) -> ctypes.CDLL:
    """The library at ``path`` with its entry points' signatures set (and
    ``kde_loo_set_diag``'s where it is a diag build, ``-DK4_DIAG``)."""
    lib = ctypes.CDLL(str(path))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.kde_loo_search_scratch.argtypes = [i, i, i, i]
    lib.kde_loo_search_scratch.restype = ctypes.c_longlong
    lib.kde_loo_search.argtypes = [vp] * 9 + [i, i, f, i, f, f, i, vp]
    lib.kde_loo_search.restype = i
    lib.kde_loo_rows_scratch.argtypes = [i] * 8
    lib.kde_loo_rows_scratch.restype = ctypes.c_longlong
    lib.kde_loo_rows.argtypes = ([vp] * 9 + [i, i, f, i, f, f, i, i, i, i,
                                             i, vp])
    lib.kde_loo_rows.restype = i
    if hasattr(lib, "kde_loo_set_diag"):
        lib.kde_loo_set_diag.argtypes = [vp]
        lib.kde_loo_set_diag.restype = None
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


@functools.lru_cache(maxsize=64)
def search_tol(tol: float, dtype) -> float:
    """The stop rule's tolerance: at float32 clamped to sqrt(eps), so that
    the rule stays reachable."""
    if dtype == torch.float32:
        return max(tol, float(np.sqrt(np.finfo(np.float32).eps)))
    return tol


@functools.lru_cache(maxsize=64)
def max_iters(tol: float, dtype) -> int:
    """The bound on a search's iterations (``_golden_core``'s)."""
    tol = search_tol(tol, dtype)
    return int(np.ceil(np.log(max(tol, 1e-18)) / np.log(_R))) + 60


def new_trace(rows: torch.Tensor, tol: float) -> torch.Tensor:
    """A probe trace for :func:`loo_search` of ``rows``: ``[R, max_iters +
    2, 2]`` of NaN, filled with each row's probes ``(x, f(x))`` in order (x1
    and x2 first, then one per iteration while the row searches)."""
    return torch.full((rows.shape[0], max_iters(tol, rows.dtype) + 2, 2),
                      math.nan, dtype=rows.dtype, device=rows.device)


def _golden_core(f, ax, bx, cx, tol, trace=None):
    """Golden-section minimization of a batch of independent 1-D problems.

    ``f`` maps a probe vector ``x -> f(x)`` elementwise; ``ax < bx < cx``
    bracket each minimum.  Each element follows exactly the trajectory of
    the reference's scalar ``golden`` (src/CrossValidation.jl:44-98):
    converged elements freeze under masked updates.  The float type is the
    brackets' own.  At float32 the tolerance is clamped to sqrt(eps) so the
    stop rule stays reachable, and ``max_iters`` bounds the loop.  With a
    ``trace`` (:func:`new_trace`) the probes of each element are written to
    it as :func:`loo_search`'s kernel writes them."""
    ft = ax.dtype
    tol = search_tol(tol, ft)
    n_iters = max_iters(tol, ft)
    x0, x3 = ax, cx
    x1, x2 = golden_start(ax, bx, cx)
    f1 = f(x1).to(ft)
    f2 = f(x2).to(ft)
    if trace is not None:
        trace[:, 0] = torch.stack([x1, f1], 1)
        trace[:, 1] = torch.stack([x2, f2], 1)
    for it in range(n_iters):
        active = golden_active(x0, x1, x2, x3, tol)
        if not bool(active.any()):
            break
        (x0, x1, x2, x3), take2, take1, probe = golden_update(
            x0, x1, x2, x3, f1, f2, active)
        fp = f(probe).to(ft)                       # one probe per element
        if trace is not None:
            trace[:, 2 + it] = torch.where(active[:, None],
                                           torch.stack([probe, fp], 1),
                                           trace[:, 2 + it])
        f1, f2 = golden_fold(f1, f2, fp, take2, take1)
    return torch.where(f1 < f2, x1, x2), torch.minimum(f1, f2)


def golden_start(ax, bx, cx):
    """The first two probes ``x1 < x2`` of the reference's ``golden`` in
    the bracket ``ax < bx < cx``."""
    wide_right = (cx - bx).abs() > (bx - ax).abs()
    x1 = torch.where(wide_right, bx, bx - _C * (bx - ax))
    x2 = torch.where(wide_right, bx + _C * (cx - bx), bx)
    return x1, x2


def golden_active(x0, x1, x2, x3, tol: float):
    """The rows whose bracket is still wider than the stop rule allows."""
    return (x3 - x0).abs() > tol * (x1.abs() + x2.abs())


def golden_update(x0, x1, x2, x3, f1, f2, active):
    """One masked bracket update: an active row with ``f2 < f1`` slides
    its bracket right (``take2``), another active row slides it left
    (``take1``), a frozen row keeps it.  Returns the new ``(x0, x1, x2,
    x3)``, ``take2``, ``take1`` and each row's next probe."""
    take2 = (f2 < f1) & active
    take1 = (~take2) & active
    # branch A (f2 < f1): slide the bracket right
    nx0 = torch.where(take2, x1, x0)
    nx1 = torch.where(take2, x2, x1)
    nx2 = torch.where(take2, _R * x2 + _C * x3, x2)
    # branch B: slide it left
    nx3 = torch.where(take1, x2, x3)
    nx2 = torch.where(take1, x1, nx2)
    nx1 = torch.where(take1, _R * x1 + _C * x0, nx1)
    return (nx0, nx1, nx2, nx3), take2, take1, torch.where(take2, nx2, nx1)


def golden_fold(f1, f2, fp, take2, take1):
    """``(f1, f2)`` after :func:`golden_update`'s probe gave ``fp``."""
    return (torch.where(take2, f2, torch.where(take1, fp, f1)),
            torch.where(take2, fp, torch.where(take1, f1, f2)))


def make_nloo(rows, base_var, w, impl, chunk):
    """The golden search's probe: the LOO entropies of ``rows`` with
    variance ``base_var * x^2`` (``alpha = x^2`` in std units, reference
    src/CrossValidation.jl:15-24).  The dense route computes the pairwise
    distances once; the chunked and tiled routes recompute them per
    probe."""
    if impl == "dense":
        d2 = loo_pairwise_d2(rows)
        return lambda x: loo_entropy_given_d2(d2, (x ** 2) * base_var, w)
    return lambda x: batched_loo_entropy(rows, x ** 2, base_var, w,
                                         impl=impl, chunk=chunk)


def loo_search_ref(rows: torch.Tensor, w: torch.Tensor,
                   base_var: torch.Tensor, ax: torch.Tensor,
                   bx: torch.Tensor, cx: torch.Tensor, *, tol: float = 1e-2,
                   impl: str = "dense", chunk: int = 1024,
                   trace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of :func:`loo_search`, on any device: :func:`_golden_core`
    over :func:`make_nloo`'s probe of route ``impl``, one host read an
    iteration."""
    nloo = make_nloo(rows, base_var, w, impl, chunk)
    xmin, _ = _golden_core(nloo, ax, bx, cx, float(tol), trace=trace)
    return xmin


def _check(rows, w, base_var, ax, bx, cx, trace, tol) -> torch.device:
    if rows.dim() != 2 or w.shape != rows.shape[1:]:
        raise ValueError(f"loo_search needs rows [R, N] and w [N]; got "
                         f"{tuple(rows.shape)}, {tuple(w.shape)}")
    if any(t.shape != rows.shape[:1] for t in (base_var, ax, bx, cx)):
        raise ValueError(f"loo_search needs [R] brackets for rows "
                         f"{tuple(rows.shape)}, got "
                         f"{[tuple(t.shape) for t in (base_var, ax, bx, cx)]}")
    ts = [rows, w, base_var, ax, bx, cx] + ([] if trace is None else [trace])
    devs = {t.device for t in ts}
    dev = rows.device
    if len(devs) != 1 or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"loo_search: inputs must all lie on the CPU or on "
                         f"one CUDA device, got {sorted(map(str, devs))}")
    if rows.dtype not in (torch.float32, torch.float64) or any(
            t.dtype != rows.dtype for t in ts):
        raise TypeError(f"loo_search takes float32 or float64 throughout, "
                        f"got {[t.dtype for t in ts]}")
    shape = (rows.shape[0], max_iters(tol, rows.dtype) + 2, 2)
    if trace is not None and tuple(trace.shape) != shape:
        raise ValueError(f"loo_search: trace must be new_trace's shape, got "
                         f"{tuple(trace.shape)}")
    return dev


def loo_search(rows: torch.Tensor, w: torch.Tensor, base_var: torch.Tensor,
               ax: torch.Tensor, bx: torch.Tensor, cx: torch.Tensor, *,
               tol: float = 1e-2, impl: str = "dense", chunk: int = 1024,
               trace: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The minimizing ``x`` ``[R]`` of each row's golden search over the LOO
    entropy of ``rows [R, N]`` (shared weights ``w [N]``, normalized) with
    variance ``base_var * x^2``, from the bracket ``ax < bx < cx`` (each
    ``[R]``); float32 or float64 throughout.  CPU tensors take
    :func:`loo_search_ref` on route ``impl``.  CUDA tensors launch the
    kernel once for every ``MAX_ROWS`` rows; nothing reads the device.
    ``trace`` (:func:`new_trace`) receives every probe and its value."""
    global LAUNCHES, ROWS_LAUNCHES
    dev = _check(rows, w, base_var, ax, bx, cx, trace, tol)
    if dev.type == "cpu":
        return loo_search_ref(rows, w, base_var, ax, bx, cx, tol=tol,
                              impl=impl, chunk=chunk, trace=trace)
    r, n = rows.shape
    if r == 0:
        return rows.new_empty((0,))
    if r > MAX_ROWS:
        return torch.cat([loo_search(
            rows[k:k + MAX_ROWS], w, base_var[k:k + MAX_ROWS],
            ax[k:k + MAX_ROWS], bx[k:k + MAX_ROWS], cx[k:k + MAX_ROWS],
            tol=tol, impl=impl, chunk=chunk,
            trace=None if trace is None else trace[k:k + MAX_ROWS])
            for k in range(0, r, MAX_ROWS)])
    if trace is not None and not trace.is_contiguous():
        raise ValueError("loo_search: the trace must be contiguous")
    plan = launch_plan(r, n, rows.dtype, _sm_count(dev.index))
    xmin = launch(_load(), rows, w, base_var, ax, bx, cx, tol, trace, plan)
    LAUNCHES += 1
    ROWS_LAUNCHES += plan.layout == "rows"
    return xmin


def launch(lib, rows, w, base_var, ax, bx, cx, tol, trace=None,
           plan: Plan = GRID):
    """One launch of library ``lib``'s search of at most ``MAX_ROWS`` CUDA
    rows on ``plan``, checked by :func:`loo_search`; uncounted.  A plan
    the kernel does not take or a refused launch raises."""
    r, n = rows.shape
    dev = rows.device
    rows, w, base_var, ax, bx, cx = (t.contiguous() for t in
                                     (rows, w, base_var, ax, bx, cx))
    f64 = int(rows.dtype == torch.float64)
    iters = max_iters(tol, rows.dtype)
    shape = (plan.blocks_per_row, plan.groups_per_block, plan.teams,
             int(plan.cluster))
    if plan.layout == "rows":
        nbytes = lib.kde_loo_rows_scratch(r, n, iters, f64, *shape)
    else:
        nbytes = lib.kde_loo_search_scratch(r, n, iters, f64)
    if nbytes < 0:
        raise ValueError(f"loo_search: rows {tuple(rows.shape)} exceed the "
                         f"kernel's index range or {plan}")
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if nbytes else None)
    xmin = torch.empty(r, dtype=rows.dtype, device=dev)
    ptrs = (rows.data_ptr(), w.data_ptr(), base_var.data_ptr(),
            ax.data_ptr(), bx.data_ptr(), cx.data_ptr(), xmin.data_ptr(),
            None if trace is None else trace.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            r, n, search_tol(float(tol), rows.dtype), iters, _C, _R, f64)
    guard = (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
             else contextlib.nullcontext())
    with guard:
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        if plan.layout == "rows":
            rc = lib.kde_loo_rows(*ptrs, *shape, stream)
        else:
            rc = lib.kde_loo_search(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"kde_loo_search launch failed ({plan.layout} "
                           f"plan): CUDA error {rc}")
    return xmin
