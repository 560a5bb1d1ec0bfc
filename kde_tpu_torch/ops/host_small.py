"""The small-problem routes, in float64 (ports ``kde_tpu/ops/host_small.py``
and ``kde_tpu/native/hostops.cpp``).

At or below the size gates ``config.HOST_LOOCV_LIMIT``, ``HOST_EVAL_LIMIT``
and ``HOST_SAMPLE_LIMIT`` the JAX package selects bandwidths, evaluates and
samples in float64 whatever the density's dtype, on the host.  Here the same
float64 work runs on the density's device: the name says where the
counterpart lives, not where the work runs.  On the card it takes the CUDA
kernels of ``csrc/small_ops.cu``; CPU tensors take their plain twins.

  * :func:`ksize_small` is ``ksize_host_np`` with ``bracket_rows_np``: one
    launch of the ``ksize_golden`` kernel does every row's bracket and
    whole golden search, each row on a thread-block cluster of
    :func:`golden_plan`'s size (twin :func:`ksize_small_ref`: the torch
    ``ops/loocv.py::bracket_rows`` and :func:`loo_golden_ref`, which is
    ``ksize_host_np``'s search with ``_golden_scalar``'s Python-float
    bracket arithmetic).  :func:`loo_golden` runs the same kernel's search
    alone from a given bracket;
  * :func:`log_eval_small` and :func:`log_eval_loo_small` are
    ``log_eval_np`` and ``log_eval_loo_np``: one launch of the
    ``small_log_eval`` kernel (twin :func:`small_log_eval_ref`);
  * :func:`sample_small` is ``sample_np``: ``ops/sampling.py::
    draw_indices`` and a gather in plain torch, no kernel.

A wrapper takes the twin only for CPU tensors; CUDA tensors launch the
kernel or raise, a refused cluster size included.  The library is built
with nvcc into ``_build/`` at the first launch, with ``--fmad=false`` so
that the bracket arithmetic rounds as ``bracket_rows`` and
``_golden_scalar`` do.  The routing lives with the callers
(``ops/loocv.py::ksize_bandwidths``, ``density.KDE.log_eval`` /
``evaluate``, ``ops/sampling.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional, Tuple

import torch

from . import loocv
from .loocv import _C, _R
from .tiled_eval import _sm_count, nvcc_build

LOG_2PI = math.log(2.0 * math.pi)
# The most points a row may have on the card: every block of its cluster
# keeps x, w and the nearest-neighbour shifts (3 N doubles) in dynamic
# shared memory (csrc/small_ops.cu's kMaxGoldenN).  The gate
# N*N*d <= HOST_LOOCV_LIMIT keeps N <= 256.
GOLDEN_MAX_N = 6000
# Rows i a block of the search takes a probe with one row a warp: the
# kernel's kWarps (512 threads).
GOLDEN_ROWS_PER_BLOCK = 16
# The plan's largest cluster: 16 blocks, a size the kernel admits with the
# non-portable attribute (the portable limit is 8).  At N = 255 on an H100
# it read 0.129 ms a call against C = 8's 0.164 (chip_smoke.py phase 3b);
# a card that holds no such cluster gets 8.
GOLDEN_MAX_CLUSTER = 16

# Launches of each CUDA kernel; a run sets them to 0 and reads them to show
# the path went through the kernels.
LAUNCHES = {"loo_golden": 0, "small_log_eval": 0}

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "small_ops.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
F64 = torch.float64

_lib = None
BUILD_LOG = ""


def build() -> Path:
    """Compile ``csrc/small_ops.cu`` (once per source and flags) and return
    the shared library's path; a failed build raises."""
    global BUILD_LOG
    out, log = nvcc_build(SOURCE, NVCC_FLAGS, "small_ops")
    BUILD_LOG = log or BUILD_LOG
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.kde_ksize_small.argtypes = [vp] * 4 + [i, vp, i, i, f, i, f, f,
                                                   i, vp]
        lib.kde_ksize_small.restype = i
        lib.kde_loo_golden.argtypes = [vp] * 7 + [i, i, f, i, f, f, i, vp]
        lib.kde_loo_golden.restype = i
        lib.kde_golden_max_clusters.argtypes = [i, i, ctypes.POINTER(i)]
        lib.kde_golden_max_clusters.restype = i
        lib.kde_small_log_eval.argtypes = [vp] * 5 + [i] * 4 + [vp]
        lib.kde_small_log_eval.restype = i
        _lib = lib
    return _lib


def _device(name: str, *tensors: torch.Tensor) -> torch.device:
    """The one device of ``tensors``, which must all be float64 and
    contiguous: the CPU (the twin) or a CUDA device (the kernel)."""
    devs = {t.device for t in tensors}
    dev = tensors[0].device
    if len(devs) != 1 or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: inputs must all lie on the CPU or on one "
                         f"CUDA device, got {sorted(map(str, devs))}")
    if any(t.dtype != F64 for t in tensors):
        raise TypeError(f"{name} takes float64, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return dev


def _checked(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


# ---- LOOCV bandwidth selection ---------------------------------------------

def golden_max_iters(tol: float) -> int:
    """``_golden_scalar``'s bound on the iterations of one search."""
    return int(math.ceil(math.log(max(tol, 1e-18)) / math.log(_R))) + 60


def golden_plan(r: int, n: int, sms: int) -> int:
    """Blocks C of the cluster that searches each of ``r`` rows of ``n``
    points on a card with ``sms`` SMs: the least power of two that gives
    every warp at most one row i a probe (``GOLDEN_ROWS_PER_BLOCK`` rows a
    block), at most ``GOLDEN_MAX_CLUSTER``, with the ``r * C`` blocks no
    more than the SMs.  C = 1 is one block a row."""
    c = 1
    while (c < GOLDEN_MAX_CLUSTER and c * GOLDEN_ROWS_PER_BLOCK < n
           and 2 * c * r <= sms):
        c *= 2
    return c


# The internal ball-tree nodes' leaf slices ``(lo, hi)`` of an ``n``-point
# row, as int64 tensors on a device, uploaded once per ``(n, device)``: a
# call of :func:`ksize_small` copies nothing to the card.
node_table = loocv._slices_on


@functools.lru_cache(maxsize=1024)
def max_clusters(n: int, cluster: int, index: int) -> int:
    """How many clusters of ``cluster`` search blocks for rows of ``n``
    points card ``index`` holds at once (``cudaOccupancyMaxActiveClusters``;
    0: the size is not admitted); a query the card refuses raises."""
    count = ctypes.c_int(0)
    with torch.cuda.device(index):
        _checked("kde_golden_max_clusters", _load().kde_golden_max_clusters(
            n, cluster, ctypes.byref(count)))
    return count.value


def _cluster(r: int, n: int, dev: torch.device,
             cluster: Optional[int]) -> int:
    """The cluster size of a launch: ``cluster`` as given (the launch
    raises if the card refuses it), else :func:`golden_plan`'s, halved
    while the card holds no such cluster."""
    if cluster is not None:
        if int(cluster) < 1:
            raise ValueError(f"cluster must be >= 1, got {cluster}")
        return int(cluster)
    c = golden_plan(r, n, _sm_count(dev.index))
    while c > 1 and max_clusters(n, c, dev.index) < 1:
        c //= 2
    return c


def _check_rows(name: str, rows: torch.Tensor, w: torch.Tensor) -> None:
    if rows.dim() != 2 or w.shape != rows.shape[1:] or rows.shape[1] < 1:
        raise ValueError(f"{name} needs rows [R, N >= 1] and w [N]; got "
                         f"{tuple(rows.shape)}, {tuple(w.shape)}")


def _card_rows(name: str, rows: torch.Tensor) -> None:
    if rows.shape[1] > GOLDEN_MAX_N:
        raise ValueError(f"{name} on the card takes N <= {GOLDEN_MAX_N} "
                         f"points a row, got {rows.shape[1]}")


def ksize_small(rows: torch.Tensor, w: torch.Tensor, tol: float = 1e-2,
                cluster: Optional[int] = None) -> torch.Tensor:
    """LOOCV std-dev bandwidths ``[R]`` of the float64 rows ``rows [R, N]``
    with normalized weights ``w [N]``, on their device (the counterpart of
    ``ksize_host_np`` with ``bracket_rows_np``).  CUDA tensors: one launch
    of the ``ksize_golden`` kernel, the bracket and the whole search of
    every row, each row on a cluster of ``cluster`` blocks (default
    :func:`golden_plan`), ``N <= GOLDEN_MAX_N``."""
    _check_rows("ksize_small", rows, w)
    dev = _device("ksize_small", rows, w)
    if dev.type == "cpu":
        return ksize_small_ref(rows, w, tol)
    _card_rows("ksize_small", rows)
    r, n = rows.shape
    lo, hi = node_table(n, dev)
    out = torch.empty(r, dtype=F64, device=dev)
    with torch.cuda.device(dev):
        _checked("kde_ksize_small", _load().kde_ksize_small(
            rows.data_ptr(), w.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            lo.numel(), out.data_ptr(), r, n, float(tol),
            golden_max_iters(tol), _C, _R, _cluster(r, n, dev, cluster),
            torch._C._cuda_getCurrentRawStream(dev.index)))
    if r:
        LAUNCHES["loo_golden"] += 1
    return out


def loo_golden(rows: torch.Tensor, w: torch.Tensor, base_var: torch.Tensor,
               ax: torch.Tensor, bx: torch.Tensor, cx: torch.Tensor,
               tol: float, cluster: Optional[int] = None) -> torch.Tensor:
    """The minimizing ``x`` of each row's golden search ``[R]`` over the LOO
    objective of ``rows [R, N]`` (weights ``w [N]``) with variance
    ``base_var * x^2``, from the bracket ``ax < bx < cx`` (each ``[R]``):
    the search of :func:`ksize_small` alone.  CUDA tensors: one launch of
    the same kernel, with the bracket passed in."""
    _check_rows("loo_golden", rows, w)
    if any(t.shape != rows.shape[:1] for t in (base_var, ax, bx, cx)):
        raise ValueError(f"loo_golden needs [R] brackets for rows "
                         f"{tuple(rows.shape)}, got {tuple(ax.shape)}")
    dev = _device("loo_golden", rows, w, base_var, ax, bx, cx)
    if dev.type == "cpu":
        return loo_golden_ref(rows, w, base_var, ax, bx, cx, tol)
    _card_rows("loo_golden", rows)
    r, n = rows.shape
    xmin = torch.empty(r, dtype=F64, device=dev)
    with torch.cuda.device(dev):
        _checked("kde_loo_golden", _load().kde_loo_golden(
            rows.data_ptr(), w.data_ptr(), base_var.data_ptr(),
            ax.data_ptr(), bx.data_ptr(), cx.data_ptr(), xmin.data_ptr(),
            r, n, float(tol), golden_max_iters(tol), _C, _R,
            _cluster(r, n, dev, cluster),
            torch._C._cuda_getCurrentRawStream(dev.index)))
    if r:
        LAUNCHES["loo_golden"] += 1
    return xmin


def _golden_scalar(f, ax: float, bx: float, cx: float, tol: float):
    """Scalar golden-section search (``kde_tpu/ops/host_small.py:71-91``,
    reference src/CrossValidation.jl:44-98) in Python floats."""
    max_iters = golden_max_iters(tol)
    x0, x3 = ax, cx
    if abs(cx - bx) > abs(bx - ax):
        x1, x2 = bx, bx + _C * (cx - bx)
    else:
        x1, x2 = bx - _C * (bx - ax), bx
    f1, f2 = f(x1), f(x2)
    it = 0
    while abs(x3 - x0) > tol * (abs(x1) + abs(x2)) and it < max_iters:
        if f2 < f1:
            x0, x1, x2 = x1, x2, _R * x2 + _C * x3
            f1, f2 = f2, f(x2)
        else:
            x3, x2, x1 = x2, x1, _R * x1 + _C * x0
            f2, f1 = f1, f(x1)
        it += 1
    return (x1, f1) if f1 < f2 else (x2, f2)


def loo_golden_ref(rows: torch.Tensor, w: torch.Tensor,
                   base_var: torch.Tensor, ax: torch.Tensor, bx: torch.Tensor,
                   cx: torch.Tensor, tol: float) -> torch.Tensor:
    """Plain twin of :func:`loo_golden`: ``ksize_host_np``'s search
    (``kde_tpu/ops/host_small.py:121-197``), row by row.  The pairwise
    ``d2`` is shifted by each query's nearest positive-weight neighbour
    (0 where it has none), dead columns give exactly 0, and with every
    weight positive the probe-independent terms fold into scalars."""
    r, n = rows.shape
    ii = torch.arange(n, device=rows.device)
    w_pos = w > 0
    all_pos = bool(w_pos.all())
    const = -0.5 * LOG_2PI - torch.log1p(-w)
    w_const = float(torch.dot(w, const))
    w_mask = torch.where(w_pos, w, 0.0)
    out = []
    for k in range(r):
        x = rows[k]
        d2 = (x[:, None] - x[None, :]) ** 2
        d2[ii, ii] = math.inf                                # LOO mask
        dmin = torch.where(w_pos[None, :], d2, math.inf).min(dim=1).values
        dmin = torch.where(torch.isfinite(dmin), dmin, 0.0)  # no live nbr
        shifted = d2 - dmin[:, None]
        shifted[:, ~w_pos] = math.inf                        # dead: exp 0
        bv, w_dmin = float(base_var[k]), float(torch.dot(w, dmin))

        def nloo(alpha):
            var = bv * alpha * alpha
            a = -0.5 / var
            pq = torch.log(torch.exp(shifted * a) @ w)
            if all_pos:
                return (-float(torch.dot(w, pq)) - a * w_dmin - w_const
                        + 0.5 * math.log(var))
            logp = pq + a * dmin + (const - 0.5 * math.log(var))
            return -float(torch.dot(w_mask, torch.where(w_pos, logp, 0.0)))

        out.append(_golden_scalar(nloo, float(ax[k]), float(bx[k]),
                                  float(cx[k]), tol)[0])
    return torch.tensor(out, dtype=F64, device=rows.device)


def _bracket(rows: torch.Tensor):
    return loocv.bracket_rows(rows, *node_table(rows.shape[1], rows.device))


def ksize_small_ref(rows: torch.Tensor, w: torch.Tensor,
                    tol: float = 1e-2) -> torch.Tensor:
    """Plain twin of :func:`ksize_small`, on any device: the torch
    ``bracket_rows``, then :func:`loo_golden_ref`."""
    base, ax, bx, cx = _bracket(rows)
    return loo_golden_ref(rows, w, base ** 2, ax, bx, cx, tol) * base


# ---- evaluation ------------------------------------------------------------

def _log_eval(query, means, var, weights, loo: bool) -> torch.Tensor:
    if (query.dim() != 2 or means.dim() != 2 or var.shape != means.shape
            or query.shape[1] != means.shape[1] or means.shape[0] < 1
            or weights.shape != means.shape[:1]):
        raise ValueError(
            f"small_log_eval needs query [M, d], means/var [N >= 1, d], "
            f"weights [N]; got {tuple(query.shape)}, {tuple(means.shape)}, "
            f"{tuple(var.shape)}, {tuple(weights.shape)}")
    dev = _device("small_log_eval", query, means, var, weights)
    if dev.type == "cpu":
        return small_log_eval_ref(query, means, var, weights, loo)
    m, d = query.shape
    out = torch.empty(m, dtype=F64, device=dev)
    with torch.cuda.device(dev):
        _checked("kde_small_log_eval", _load().kde_small_log_eval(
            query.data_ptr(), means.data_ptr(), var.data_ptr(),
            weights.data_ptr(), out.data_ptr(), m, means.shape[0], d,
            int(loo), torch._C._cuda_getCurrentRawStream(dev.index)))
    if m:
        LAUNCHES["small_log_eval"] += 1
    return out


def log_eval_small(query: torch.Tensor, means: torch.Tensor,
                   var: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``log p`` ``[M]`` of the mixture at ``query [M, d]``: means and
    variances ``[N, d]``, weights ``[N]``, all float64 (``log_eval_np``)."""
    return _log_eval(query, means, var, weights, False)


def log_eval_loo_small(points: torch.Tensor, var: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """Leave-one-out ``log p_-j(x_j)`` ``[N]`` at the mixture's own points,
    with the ``-log1p(-w_j)`` rescale (``log_eval_loo_np``)."""
    return _log_eval(points, points, var, weights, True)


def small_log_eval_ref(query: torch.Tensor, means: torch.Tensor,
                       var: torch.Tensor, weights: torch.Tensor,
                       loo: bool = False) -> torch.Tensor:
    """Plain twin of the ``small_log_eval`` kernel: the direct
    ``(q - mu)^2 / var`` logits of every (query, component) pair, a zero
    weight giving -inf, then ``logsumexp``; with ``loo`` the diagonal is
    left out and ``log1p(-w)`` subtracted."""
    diff = query[:, None, :] - means[None, :, :]
    quad = ((diff * diff / var[None, :, :]).sum(dim=2)
            + torch.log(var).sum(dim=1)[None, :])
    logits = torch.log(weights)[None, :] - 0.5 * quad
    if loo:
        logits.fill_diagonal_(-math.inf)
    out = torch.logsumexp(logits, dim=1) - 0.5 * query.shape[1] * LOG_2PI
    return out - torch.log1p(-weights) if loo else out


# ---- sampling --------------------------------------------------------------

def sample_small(points: torch.Tensor, var: torch.Tensor,
                 weights: torch.Tensor, n: int,
                 gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` draws in float64 on ``points``' device (``sample_np``): sorted
    uniforms, then normals, both from ``gen``.  Returns ``(points [d, n],
    kernel indices [n])``."""
    dev = points.device
    u = torch.rand(n, generator=gen, dtype=F64, device=dev).sort().values
    noise = torch.randn((n, points.shape[1]), generator=gen, dtype=F64,
                        device=dev)
    return draw_small(points, var, weights, u, noise)


def draw_small(points: torch.Tensor, var: torch.Tensor, weights: torch.Tensor,
               u: torch.Tensor, noise: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sample_np``'s arithmetic for given sorted uniforms ``u [n]`` and
    normals ``noise [n, d]``: the kernels of ``ops/sampling.py::
    draw_indices``, jittered by their bandwidths."""
    from .sampling import draw_indices  # sampling imports this module
    ind = draw_indices(weights, u)
    return (points[ind] + torch.sqrt(var[ind]) * noise).T, ind
