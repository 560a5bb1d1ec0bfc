"""Leave-one-out cross-validated bandwidth selection (ports
``kde_tpu/ops/loocv.py``).

Per dimension the reference builds the 1-D marginal, brackets the search
from the ball-tree geometry (``neighborMinMax``) and runs a golden-section
search minimizing the LOO entropy (reference src/CrossValidation.jl:15-120).
Here the golden searches of all ``d`` dimensions run at once as one masked
batch, and the bracket comes from a sort (the 1-D tree's internal-node
extents are sorted-slice extents, see :func:`_internal_slices`), so the fit
of a device tensor never leaves the device.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from .. import config
from .kernels import (batched_loo_entropy, entropy_kernel,
                      loo_entropy_given_d2, loo_pairwise_d2, use_tiled_eval)

_C = (3.0 - math.sqrt(5.0)) / 2.0   # golden-section constants
_R = 1.0 - _C                       # (reference src/CrossValidation.jl:51-52)


def _golden_core(f, ax, bx, cx, tol):
    """Golden-section minimization of a batch of independent 1-D problems.

    ``f`` maps a probe vector ``x -> f(x)`` elementwise; ``ax < bx < cx``
    bracket each minimum.  Each element follows exactly the trajectory of
    the reference's scalar ``golden`` (src/CrossValidation.jl:44-98):
    converged elements freeze under masked updates.  The float type is the
    brackets' own.  At float32 the tolerance is clamped to sqrt(eps) so the
    stop rule stays reachable, and ``max_iters`` bounds the loop."""
    ft = ax.dtype
    if ft == torch.float32:
        tol = max(tol, float(np.sqrt(np.finfo(np.float32).eps)))
    max_iters = int(np.ceil(np.log(max(tol, 1e-18)) / np.log(_R))) + 60
    x0, x3 = ax, cx
    wide_right = (cx - bx).abs() > (bx - ax).abs()
    x1 = torch.where(wide_right, bx, bx - _C * (bx - ax))
    x2 = torch.where(wide_right, bx + _C * (cx - bx), bx)
    f1 = f(x1).to(ft)
    f2 = f(x2).to(ft)
    for _ in range(max_iters):
        active = (x3 - x0).abs() > tol * (x1.abs() + x2.abs())
        if not bool(active.any()):
            break
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
        fp = f(torch.where(take2, nx2, nx1)).to(ft)   # one probe per element
        nf1 = torch.where(take2, f2, torch.where(take1, fp, f1))
        nf2 = torch.where(take2, fp, torch.where(take1, f1, f2))
        x0, x1, x2, x3, f1, f2 = nx0, nx1, nx2, nx3, nf1, nf2
    return torch.where(f1 < f2, x1, x2), torch.minimum(f1, f2)


def golden_batched(f, ax, bx, cx, tol):
    """Golden-section minimization of a batch of independent 1-D problems
    (``kde_tpu/ops/loocv.py:34-50``; reference ``golden``,
    src/CrossValidation.jl:44-98): ``f`` maps a probe tensor to its values
    elementwise, ``ax < bx < cx`` bracket each minimum.  Returns NumPy
    ``(xmin, fmin)``."""
    def t(x):
        x = torch.as_tensor(x)
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


def _slices_on(n: int, device):
    lo, hi = _internal_slices(n)
    return (torch.as_tensor(lo, device=device),
            torch.as_tensor(hi, device=device))


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


def _make_nloo(rows, base_var, w, impl, chunk):
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


def ksize_rows(rows: torch.Tensor, w: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor, *, tol: float = 1e-2, impl: str = "dense",
               chunk: int = 1024) -> torch.Tensor:
    """LOOCV std-dev bandwidths ``[R]`` of ``R`` independent 1-D problems
    ``rows [R, N]`` sharing weights ``w [N]``."""
    base, ax, bx, cx = bracket_rows(rows, lo, hi)
    nloo = _make_nloo(rows, base ** 2, w, impl, chunk)
    xmin, _ = _golden_core(nloo, ax, bx, cx, float(tol))
    return xmin * base


def ksize_bandwidths(points: np.ndarray, weights: np.ndarray,
                     tol: float = 1e-2, dtype=torch.float64,
                     device=None) -> np.ndarray:
    """Per-dimension LOOCV bandwidths (std-devs, NumPy ``[d]``) for NumPy
    ``points [N, d]`` -- the reference's per-dim ``ksize(marginal(p, [i]))``
    loop (src/KDE01.jl:17-23), all dims searched at once in ``dtype`` on
    ``device`` (default ``config.DEVICE``, the card)."""
    device = config.default_device(device)
    pts = np.asarray(points, dtype=np.float64)
    n, d = pts.shape
    w = np.asarray(weights, dtype=np.float64).reshape(n)
    w = w / w.sum()
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
