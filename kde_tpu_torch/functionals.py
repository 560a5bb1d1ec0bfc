"""Density functionals: average log-likelihood, entropy, KL divergence,
overlap integrals and summary statistics (ports ``kde_tpu/functionals.py``;
reference src/DualTree01.jl:450-618).

Compositions over the evaluator (ops/kernels.py).  The summaries have a
host branch for densities built from NumPy, which returns NumPy, and a
tensor branch for tensor-backed densities (``_host_points is None``, e.g. a
product's output), which returns tensors on the density's device, as the
JAX package's host and device branches do.  Manifold hooks widen ranges and
grids with ``addop``/``diffop``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import manifolds
from .density import KDE, kde
from .ops import kernels


def eval_avg_logl(p1: KDE, p2: KDE) -> torch.Tensor:
    """``sum_j w2_j log p1(x2_j)``, the weighted average log-likelihood of
    ``p1`` at ``p2``'s points (reference src/DualTree01.jl:450-470); when
    ``p1 is p2`` the evaluation is leave-one-out (:333).  Above the size
    gates a float32 Euclidean ``p1`` takes the tiled route."""
    if p1 is p2:
        logp = kernels.log_eval_loo(p1.points, p1.bw, p1.weights,
                                    p1._eval_diffop)
    else:
        q = p2.points.to(device=p1.device, dtype=p1.dtype).contiguous()
        logp = kernels.log_eval_gated(q, p1.points, p1.bw, p1.weights,
                                      p1._eval_diffop)
    return kernels.eval_avg_logl_from_logp(
        logp, p2.weights.to(device=logp.device, dtype=logp.dtype))


def entropy(p: KDE) -> torch.Tensor:
    """H(p) = -avg LOO log-likelihood (reference src/DualTree01.jl:505-508)."""
    return -eval_avg_logl(p, p)


def kld(p1: KDE, p2: KDE, method: str = "direct") -> torch.Tensor:
    """Approximate D_KL(p1 || p2) (reference src/DualTree01.jl:477-503).

    ``direct``: evaluated at p1's own points (LOO for the p1 term).
    ``unscented``: the 2d+1 blocks of p1's points, each shifted by +/- one
    bandwidth std along one dimension (the reference's indexing,
    :494-499), get a fresh LOOCV fit on p1's device, and both densities are
    evaluated at it."""
    if method == "direct":
        return eval_avg_logl(p1, p1) - eval_avg_logl(p2, p1)
    if method == "unscented":
        d, n = p1.ndim, p1.npts
        pts = p1.get_points()                                     # [d, N]
        bwstd = p1.get_bw()                                       # [d, N]
        pts_e = pts.repeat(1, 2 * d + 1)
        for i in range(d):
            pts_e[i, i * n:(i + 1) * n] += bwstd[i]
            pts_e[i, (2 * i + 1) * n:(2 * i + 2) * n] -= bwstd[i]
        pe = kde(pts_e)
        return eval_avg_logl(p1, pe) - eval_avg_logl(p2, pe)
    raise ValueError(f"unknown kld method {method!r}")


def minkld(p: KDE, q: KDE) -> torch.Tensor:
    """min(|kld(p,q)|, |kld(q,p)|) (reference src/DualTree01.jl:510)."""
    return torch.minimum(torch.abs(kld(p, q)), torch.abs(kld(q, p)))


# ---- summary statistics (reference src/DualTree01.jl:512-578) ---------------

def _ops(p: KDE):
    return (p.addop or (manifolds.euclid_add,) * p.ndim,
            p.diffop or (manifolds.euclid_diff,) * p.ndim)


def _extent(lo, hi, extend, addop, diffop):
    """``(lo - dr, hi + dr)`` with ``dr = extend * (hi - lo)``, each taken
    with the dimension's manifold ops."""
    dr = extend * diffop(hi, lo)
    return diffop(lo, dr), addop(hi, dr)


def _linspace(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` points from ``lo`` to ``hi`` (0-dim tensors), without a
    device-to-host read of the ends."""
    t = torch.linspace(0.0, 1.0, n, dtype=lo.dtype, device=lo.device)
    return torch.where(t == 1.0, hi, lo + (hi - lo) * t)


def get_kde_range(p, extend: float = 0.1):
    """Point extent per dim, widened by ``extend``: ``[d, 2]``.  A list of
    densities gives the elementwise union (src/DualTree01.jl:540-550)."""
    if isinstance(p, (list, tuple)):
        ranges = [get_kde_range(q, extend) for q in p]
        if any(isinstance(r, torch.Tensor) for r in ranges):
            dev = next(r.device for r in ranges
                       if isinstance(r, torch.Tensor))
            rs = [torch.as_tensor(r, device=dev) for r in ranges]
            rv = rs[0]
            for r2 in rs[1:]:
                rv = torch.stack([torch.minimum(rv[:, 0], r2[:, 0]),
                                  torch.maximum(rv[:, 1], r2[:, 1])], dim=1)
            return rv
        rv = ranges[0]
        for r2 in ranges[1:]:
            rv[:, 0] = np.minimum(rv[:, 0], r2[:, 0])
            rv[:, 1] = np.maximum(rv[:, 1], r2[:, 1])
        return rv
    addop, diffop = _ops(p)
    if p._host_points is None:
        lo, hi = p.points.min(dim=0).values, p.points.max(dim=0).values
        return torch.stack([torch.stack(_extent(lo[i], hi[i], extend,
                                                addop[i], diffop[i]))
                            for i in range(p.ndim)])
    pts = torch.as_tensor(p.host_points())                    # [d, N], f64
    rv = np.empty((p.ndim, 2))
    for i in range(p.ndim):
        rv[i] = [float(v) for v in _extent(pts[i].min(), pts[i].max(),
                                           extend, addop[i], diffop[i])]
    return rv


def get_kde_range_linspace(p: KDE, extend: float = 0.1, n: int = 200):
    """``n`` grid points over the first dim's widened extent."""
    v = get_kde_range(p, extend)
    if isinstance(v, torch.Tensor):
        return _linspace(v[0, 0], v[0, 1], n)
    return np.linspace(v[0, 0], v[0, 1], n)


def get_kde_max(p: KDE, n: int = 200):
    """Per-dimension argmax of the marginal density over an ``n``-point
    grid of its widened extent (reference src/DualTree01.jl:558-569)."""
    if p._host_points is None:
        addop, diffop = _ops(p)
        euclid = p._eval_diffop is None
        outs = []
        for i in range(p.ndim):
            x = p.points[:, i]
            g = _linspace(*_extent(x.min(), x.max(), 0.1, addop[i],
                                   diffop[i]), n)
            logp = kernels.log_eval(g[:, None], p.points[:, i:i + 1],
                                    p.bw[:, i:i + 1], p.weights,
                                    None if euclid else (diffop[i],))
            outs.append(g[torch.argmax(logp)])
        return torch.stack(outs)
    out = np.empty(p.ndim)
    for i in range(p.ndim):
        mm = p.marginal([i])
        x = get_kde_range_linspace(mm, extend=0.1, n=n)
        y = mm.evaluate(x[None, :]).cpu().numpy()
        out[i] = x[int(np.argmax(y))]
    return out


def get_kde_mean(p: KDE):
    if p._host_points is None:
        return p.points.mean(dim=0)
    return p.host_points().mean(axis=1)


def get_kde_fit(p: KDE) -> Tuple:
    """Maximum-likelihood Gaussian fit to the points: (mean [d],
    cov [d, d]) (reference src/DualTree01.jl:575-578)."""
    if p._host_points is None:
        mu = p.points.mean(dim=0)
        xc = p.points - mu[None, :]
        return mu, xc.T @ xc / p.npts
    pts = p.host_points()
    mu = pts.mean(axis=1)
    xc = pts - mu[:, None]
    return mu, xc @ xc.T / pts.shape[1]


def inters_intg_appx_is(p: KDE, q: KDE, n: int = 201):
    """Overlap integral ``int p(x) q(x) dx`` by grid quadrature over p's
    extent widened by 0.3, dims <= 2 only (reference
    src/DualTree01.jl:581-618).  A tensor-backed ``p`` or ``q`` gives a
    tensor on the device; host-backed densities give a float.  The 2-D
    grid is evaluated in blocks of 4096 queries, never on the tiled route,
    as in the JAX package."""
    d = p.ndim
    if d > 2:
        raise NotImplementedError(
            "intersIntgAppxIS supports dims <= 2 "
            "(as in the reference, src/DualTree01.jl:615)")
    if p._host_points is None or q._host_points is None:
        addop, diffop = _ops(p)
        lo, hi = p.points.min(dim=0).values, p.points.max(dim=0).values
        grids = [_linspace(*_extent(lo[k], hi[k], 0.3, addop[k], diffop[k]),
                           n) for k in range(d)]
        if d == 1:
            xx, chunk = grids[0][:, None], None
        else:
            gx, gy = torch.meshgrid(grids[0], grids[1], indexing="xy")
            xx, chunk = torch.stack([gx.reshape(-1), gy.reshape(-1)], 1), 4096
        qq = q.points.to(p.dtype)
        yy = (torch.exp(kernels.log_eval(xx, p.points, p.bw, p.weights,
                                         p._eval_diffop, chunk=chunk))
              * torch.exp(kernels.log_eval(xx, qq, q.bw.to(p.dtype),
                                           q.weights.to(p.dtype),
                                           q._eval_diffop, chunk=chunk)))
        vol = grids[0][1] - grids[0][0]
        if d == 2:
            vol = vol * (grids[1][1] - grids[1][0])
        return yy.sum() * vol
    grids = [get_kde_range_linspace(p.marginal([k]), extend=0.3, n=n)
             for k in range(d)]
    ev = lambda k, x, **kw: k.evaluate(x, **kw).cpu().numpy()
    if d == 1:
        xx = grids[0][None, :]
        return float((ev(p, xx) * ev(q, xx)).sum()
                     * (grids[0][1] - grids[0][0]))
    gx, gy = np.meshgrid(grids[0], grids[1], indexing="xy")
    xx = np.stack([gx.ravel(), gy.ravel()])                       # [2, n*n]
    yy = ev(p, xx, chunk=4096) * ev(q, xx, chunk=4096)
    return float(yy.sum() * (grids[0][1] - grids[0][0])
                 * (grids[1][1] - grids[1][0]))


def evaluate_dual_tree(p: KDE, pos, lv_flag: bool = False,
                       err_tol: float = 1e-3) -> torch.Tensor:
    """The reference's ``evaluateDualTree`` (src/DualTree01.jl:370-421):
    ``pos`` may be positions or a KDE (its points; ``p`` itself means
    leave-one-out).  Evaluation is exact; ``err_tol`` is accepted for
    compatibility."""
    if isinstance(pos, KDE):
        if lv_flag or pos is p:
            return p.evaluate(None, lv_flag=True)
        if pos._host_points is not None:
            # a NumPy-built query density stays NumPy, so a small
            # evaluation takes the float64 route (kde_tpu/functionals.py:272)
            return p.evaluate(pos.host_points())
        return p.evaluate(pos.get_points())
    return p.evaluate(pos, lv_flag=lv_flag, err_tol=err_tol)
