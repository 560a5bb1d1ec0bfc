"""The LOOCV golden-section search of ``R`` independent 1-D rows in one
launch (the port's K4; on the TPU ``kde_tpu/ops/loocv.py::_ksize_search``,
one jitted ``lax.while_loop`` around the probe, the Pallas kernel K1 above
``LOOCV_PAIR_LIMIT``).

:func:`loo_search` returns the minimizing ``x`` of every row's search over
the LOO entropy with variance ``base_var * x^2``, from the bracket
``ax < bx < cx``.  CUDA tensors launch the hand-written kernel
``csrc/loo_search.cu`` once, with no host read: the probes, the loop and
its stop rule all stay on the card.  CPU tensors take the plain twin
:func:`loo_search_ref`, the eager golden loop :func:`_golden_core` over the
probe route ``impl`` (``dense``, ``chunk`` or ``tiled``, as
``ops/loocv.py::select_loo_impl`` picks it; on the card the route only
says what the twin would do).  The library is built with nvcc
(``--fmad=false``) into ``_build/`` at the first launch; a failed build, a
refused launch (a grid that cannot be co-resident included) or an input
the kernel does not take raises, and nothing falls back.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .kernels import (batched_loo_entropy, loo_entropy_given_d2,
                      loo_pairwise_d2)
from .tiled_eval import nvcc_build

_C = (3.0 - math.sqrt(5.0)) / 2.0   # golden-section constants
_R = 1.0 - _C                       # (reference src/CrossValidation.jl:51-52)

# Launches of the CUDA kernel; a run sets it to 0 and reads it to show the
# path went through the kernel.
LAUNCHES = 0

# The most rows one launch takes: every block keeps each row's search state
# in shared memory (csrc/loo_search.cu's kMaxRows).  More rows take a
# launch for each MAX_ROWS of them.
MAX_ROWS = 1024

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


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.kde_loo_search_scratch.argtypes = [i, i, i, i]
        lib.kde_loo_search_scratch.restype = ctypes.c_longlong
        lib.kde_loo_search.argtypes = [vp] * 9 + [i, i, f, i, f, f, i, vp]
        lib.kde_loo_search.restype = i
        _lib = lib
    return _lib


def search_tol(tol: float, dtype) -> float:
    """The stop rule's tolerance: at float32 clamped to sqrt(eps), so that
    the rule stays reachable."""
    if dtype == torch.float32:
        return max(tol, float(np.sqrt(np.finfo(np.float32).eps)))
    return tol


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
    global LAUNCHES
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
    rows, w, base_var, ax, bx, cx = (t.contiguous() for t in
                                     (rows, w, base_var, ax, bx, cx))
    f64 = int(rows.dtype == torch.float64)
    iters = max_iters(tol, rows.dtype)
    lib = _load()
    nbytes = lib.kde_loo_search_scratch(r, n, iters, f64)
    if nbytes < 0:
        raise ValueError(f"loo_search: rows {tuple(rows.shape)} exceed the "
                         "kernel's index range")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    xmin = torch.empty(r, dtype=rows.dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.kde_loo_search(
            rows.data_ptr(), w.data_ptr(), base_var.data_ptr(),
            ax.data_ptr(), bx.data_ptr(), cx.data_ptr(), xmin.data_ptr(),
            None if trace is None else trace.data_ptr(), scratch.data_ptr(),
            r, n, search_tol(float(tol), rows.dtype), iters, _C, _R, f64,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"kde_loo_search launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return xmin
