"""Leave-one-out cross-validated bandwidth selection (ports
``kde_tpu/ops/loocv.py``).

Per dimension the reference builds the 1-D marginal, brackets the search
from the ball-tree geometry (``neighborMinMax``) and runs a golden-section
search minimizing the LOO entropy (reference src/CrossValidation.jl:15-120).
Here the golden searches of all ``d`` dimensions run at once as one masked
batch, and the bracket comes from a sort (the 1-D tree's internal-node
extents are sorted-slice extents, see :func:`_internal_slices`), so the fit
of a device tensor never leaves the device: on the card the whole search
is one launch of ``ops/loo_search.py``'s kernel (K4).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from .. import config
from ..utils.spans import span
from .kernels import entropy_kernel, use_tiled_eval
from .loo_search import _C, _R, _golden_core, loo_search  # noqa: F401


def golden_batched(f, ax, bx, cx, tol):
    """Golden-section minimization of a batch of independent 1-D problems
    (``kde_tpu/ops/loocv.py:34-50``; reference ``golden``,
    src/CrossValidation.jl:44-98): ``f`` maps a probe tensor to its values
    elementwise, ``ax < bx < cx`` bracket each minimum.  Returns NumPy
    ``(xmin, fmin)``.  NumPy or list brackets go to ``config.DEVICE``, as
    the JAX package puts them on its default device; tensors keep theirs."""
    def t(x):
        x = torch.as_tensor(x, device=config.input_device(x))
        return x if x.is_floating_point() else x.to(torch.float64)
    xmin, fmin = _golden_core(f, t(ax), t(bx), t(cx), float(tol))
    return xmin.cpu().numpy(), fmin.cpu().numpy()


@functools.lru_cache(maxsize=256)
def _internal_slices(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Leaf-position slices ``[lo, hi]`` of every internal ball-tree node of
    an ``n``-point tree, root first.  The builder's recursion depends only
    on ``n`` (median split at ``(lo+hi)//2``), and in 1-D the median splits
    sort the leaves, so a node's box extent is ``sorted[hi] - sorted[lo]``:
    all that ``neighbor_min_max`` needs."""
    los, his = [], []
    stack = [(0, n - 1)]
    while stack:
        lo, hi = stack.pop()
        if lo >= hi:
            continue
        los.append(lo)
        his.append(hi)
        split = (lo + hi) // 2
        if split + 1 < hi:
            stack.append((split + 1, hi))
        if split > lo:
            stack.append((lo, split))
    return np.asarray(los, dtype=np.int64), np.asarray(his, dtype=np.int64)


@functools.lru_cache(maxsize=256)
def _slices_on(n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_internal_slices` as int64 tensors on ``device``, uploaded once
    per ``(n, device)``: a search of CUDA rows copies nothing to the card
    (an upload from pageable memory would wait for the host)."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in _internal_slices(n))


def select_loo_impl(n: int, dtype) -> str:
    """LOO-entropy route for ``n`` components: ``dense`` up to
    ``config.LOOCV_PAIR_LIMIT`` N*N pairs; above it ``tiled`` for float32
    (the JAX package's ``pallas``) and ``chunk`` for float64."""
    if n * n > config.LOOCV_PAIR_LIMIT:
        return "tiled" if use_tiled_eval(dtype) else "chunk"
    return "dense"


def bracket_rows(rows: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """Sort-based neighborMinMax bracket of ``R`` independent 1-D problems
    ``rows [R, N]`` (reference src/CrossValidation.jl:100-120, with its
    n < 2 guard and 1e-6 floor).  Returns ``(base, ax, bx, cx)``, ``[R]``
    each."""
    r, n = rows.shape
    if n < 2 or lo.shape[0] == 0:
        minm = maxm = torch.full((r,), 1e-6, dtype=rows.dtype,
                                 device=rows.device)
    else:
        s = torch.sort(rows, dim=1).values
        diag = s[:, hi] - s[:, lo]
        maxm = diag[:, 0]
        minm = diag.min(dim=1).values.clamp_min(1e-6)
    base = (minm + maxm) / 2.0
    ax = 2.0 * minm / (minm + maxm)
    bx = torch.ones_like(base)
    cx = 2.0 * maxm / (minm + maxm)
    return base, ax, bx, cx


def ksize_rows(rows: torch.Tensor, w: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor, *, tol: float = 1e-2, impl: str = "dense",
               chunk: int = 1024) -> torch.Tensor:
    """LOOCV std-dev bandwidths ``[R]`` of ``R`` independent 1-D problems
    ``rows [R, N]`` sharing weights ``w [N]``: the sort bracket, then
    :func:`loo_search` (on CUDA rows one kernel launch and no host read;
    ``impl`` and ``chunk`` pick the twin's probe route on the CPU)."""
    with span("loocv.bracket", rows=rows.shape[0], n=rows.shape[1]):
        base, ax, bx, cx = bracket_rows(rows, lo, hi)
    with span("loocv.search", impl=impl):
        xmin = loo_search(rows, w, base ** 2, ax, bx, cx, tol=float(tol),
                          impl=impl, chunk=chunk)
    return xmin * base


def ksize_bandwidths(points: np.ndarray, weights: np.ndarray,
                     tol: float = 1e-2, dtype=torch.float64,
                     device=None) -> np.ndarray:
    """Per-dimension LOOCV bandwidths (std-devs, NumPy ``[d]``) for NumPy
    ``points [N, d]`` -- the reference's per-dim ``ksize(marginal(p, [i]))``
    loop (src/KDE01.jl:17-23), all dims searched at once in ``dtype`` on
    ``device`` (default ``config.DEVICE``, the card).  At or below
    ``config.HOST_LOOCV_LIMIT`` N*N*d the search runs in float64 whatever
    ``dtype`` is (``ops/host_small.py::ksize_small``, as
    ``kde_tpu/ops/loocv.py:208-214``)."""
    device = config.default_device(device)
    pts = np.asarray(points, dtype=np.float64)
    n, d = pts.shape
    w = np.asarray(weights, dtype=np.float64).reshape(n)
    w = w / w.sum()
    if n * n * d <= config.HOST_LOOCV_LIMIT:
        from .host_small import ksize_small    # host_small imports this
        rows = torch.as_tensor(np.ascontiguousarray(pts.T), device=device)
        return ksize_small(rows, torch.as_tensor(w, device=device),
                           float(tol)).cpu().numpy()
    rows = torch.as_tensor(np.ascontiguousarray(pts.T), dtype=dtype,
                           device=device)
    w_t = torch.as_tensor(w, dtype=dtype, device=device)
    lo, hi = _slices_on(n, device)
    bw = ksize_rows(rows, w_t, lo, hi, tol=float(tol),
                    impl=select_loo_impl(n, dtype),
                    chunk=int(config.LOOCV_CHUNK))
    return bw.cpu().double().numpy()


def device_fit_arrays(pts_dn: torch.Tensor, weights=None,
                      tol: float = 1e-2):
    """The LOOCV fit of a ``[d, n]`` tensor on its own device:
    ``(points [n, d], var [n, d], weights [n])`` ready for ``KDE`` (the
    ``*`` operator's refit, reference src/MSGibbs01.jl:724-725)."""
    d, n = pts_dn.shape
    if weights is None:
        w = torch.full((n,), 1.0 / n, dtype=pts_dn.dtype,
                       device=pts_dn.device)
    else:
        w = torch.as_tensor(weights, dtype=pts_dn.dtype,
                            device=pts_dn.device).reshape(n)
        w = w / w.sum()
    lo, hi = _slices_on(n, pts_dn.device)
    bwds = ksize_rows(pts_dn, w, lo, hi, tol=float(tol),
                      impl=select_loo_impl(n, pts_dn.dtype),
                      chunk=int(config.LOOCV_CHUNK))
    var = (bwds ** 2)[None, :].expand(n, d).contiguous()
    return pts_dn.T.contiguous(), var, w


def ksize_bandwidths_device(points: torch.Tensor, weights=None,
                            tol: float = 1e-2, dtype=None) -> torch.Tensor:
    """LOOCV std-dev bandwidths ``[d]`` of ``points [N, d]`` on the tensor's
    own device, or on ``config.DEVICE`` for NumPy input (same selection as
    :func:`ksize_bandwidths`)."""
    points = torch.as_tensor(points, dtype=dtype,
                             device=config.input_device(points))
    n, d = points.shape
    if weights is None:
        w = torch.full((n,), 1.0 / n, dtype=points.dtype,
                       device=points.device)
    else:
        w = torch.as_tensor(weights, dtype=points.dtype,
                            device=points.device)
        w = w / w.sum()
    lo, hi = _slices_on(n, points.device)
    return ksize_rows(points.T.contiguous(), w, lo, hi, tol=float(tol),
                      impl=select_loo_impl(n, points.dtype),
                      chunk=int(config.LOOCV_CHUNK))


def nloo_ll(alpha: float, p, dtype=torch.float64) -> float:
    """Negative average LOO log-likelihood of ``p`` with its variances
    scaled by ``alpha^2`` (std units; reference nLOO_LL,
    src/CrossValidation.jl:15-24), computed in ``dtype`` on ``p``'s
    device.  Uniform-bandwidth densities only, as in the reference
    (:10)."""
    if p.multibandwidth:
        raise ValueError("nLOO_LL requires a uniform bandwidth "
                         "(reference src/CrossValidation.jl:10)")
    scale = float(alpha) ** 2
    return float(entropy_kernel(p.points.to(dtype), p.bw.to(dtype) * scale,
                                p.weights.to(dtype)))


def ksize(p, dtype=torch.float64):
    """LOOCV refit of a density (reference ksize,
    src/CrossValidation.jl:110-120): fresh per-dim bandwidths, searched in
    ``dtype``, for ``p``'s points and weights.  The refit keeps ``p``'s
    device, dtype and manifold hooks (the search itself is Euclidean, as
    the reference's); a tensor-backed ``p`` refits without leaving its
    device."""
    from ..density import kde
    if p._host_points is None:
        bwds = ksize_bandwidths_device(p.points, p.weights, dtype=dtype)
        return kde(p.get_points(), bwds, p.weights, **p._hooks,
                   dtype=p.dtype)
    pts, w = p.host_points(), p.host_weights()
    bwds = ksize_bandwidths(pts.T, w, dtype=dtype, device=p.device)
    return kde(pts, bwds, w, **p._hooks, device=p.device, dtype=p.dtype)
