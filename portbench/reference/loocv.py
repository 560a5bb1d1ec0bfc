"""The plain reference of the LOOCV bandwidth search, in PyTorch.

KernelDensityEstimate.jl's ``ksize`` fits each dim of a belief alone: the
bracket comes from the 1-D ball tree (``neighborMinMax``: the smallest and
the largest extent of its internal nodes, src/CrossValidation.jl:100-120),
and a scalar golden-section search (src/CrossValidation.jl:44-98) minimizes
the leave-one-out entropy ``-sum_j w_j log p_-j(x_j)`` of the dim with
variance ``(base * a)^2`` (src/CrossValidation.jl:15-24).  The tree splits a
slice of sorted points at its middle, so an internal node's extent is
``sorted[hi] - sorted[lo]`` of its slice.  The entropy runs in the dtype of
its input, in blocks of queries; the golden steps in Python floats.  It
imports nothing of the program.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


C = (3.0 - math.sqrt(5.0)) / 2.0
R = 1.0 - C
LOG_2PI = math.log(2.0 * math.pi)
# elements of one [queries, points] block
BLOCK = 1 << 25


def rows_per_block(cols: int) -> int:
    return max(1, BLOCK // max(1, cols))


@functools.lru_cache(maxsize=16)
def internal_slices(n: int):
    """``(lo, hi)`` leaf slices of every internal node of an ``n``-point
    tree that splits ``[lo, hi]`` at ``(lo + hi) // 2``, root first."""
    los, his = [], []
    stack = [(0, n - 1)]
    while stack:
        lo, hi = stack.pop()
        if lo >= hi:
            continue
        los.append(lo)
        his.append(hi)
        mid = (lo + hi) // 2
        stack += [(mid + 1, hi), (lo, mid)]
    return np.asarray(los), np.asarray(his)


def bracket(row: torch.Tensor):
    """``(base, ax, bx, cx)`` of one dim ``row [n]``: neighborMinMax's
    smallest (at least 1e-6) and largest node extent, their mean as the
    base and the bracket in units of it."""
    lo, hi = internal_slices(row.shape[0])
    s = torch.sort(row.double()).values
    ext = s[torch.as_tensor(hi, device=row.device)] \
        - s[torch.as_tensor(lo, device=row.device)]
    maxm = float(ext[0])
    minm = max(float(ext.min()), 1e-6)
    return ((minm + maxm) / 2.0, 2.0 * minm / (minm + maxm), 1.0,
            2.0 * maxm / (minm + maxm))


def loo_entropy(row: torch.Tensor, w: torch.Tensor, var: float) -> float:
    """``-sum_j w_j log p_-j(x_j)`` of the 1-D mixture of ``row [n]``,
    weights ``w [n]`` and variance ``var``, with the reference's
    ``1 / (1 - w_j)`` rescale, in the dtype of ``row``."""
    n = row.shape[0]
    v = torch.as_tensor(var, dtype=row.dtype, device=row.device)
    offs = torch.log(w) - 0.5 * torch.log(v)
    scale = -0.5 / float(v)
    rows = rows_per_block(n)
    total = torch.zeros((), dtype=row.dtype, device=row.device)
    for i in range(0, n, rows):
        q = row[i:i + rows]
        t = q[:, None] - row[None, :]
        t = torch.addcmul(offs[None, :], t, t, value=scale)
        k = torch.arange(q.shape[0], device=row.device)
        t[k, k + i] = -math.inf
        logp = (torch.logsumexp(t, 1) - 0.5 * LOG_2PI
                - torch.log1p(-w[i:i + rows]))
        total = total + (w[i:i + rows] * logp).sum()
    return float(-total)


def golden(f, ax: float, bx: float, cx: float, tol: float):
    """The reference's scalar golden-section search: ``(xmin, probes)``."""
    x0, x3 = ax, cx
    if abs(cx - bx) > abs(bx - ax):
        x1, x2 = bx, bx + C * (cx - bx)
    else:
        x1, x2 = bx - C * (bx - ax), bx
    f1, f2 = f(x1), f(x2)
    probes = 2
    while abs(x3 - x0) > tol * (abs(x1) + abs(x2)):
        if f2 < f1:
            x0, x1, x2 = x1, x2, R * x2 + C * x3
            f1, f2 = f2, f(x2)
        else:
            x3, x2, x1 = x2, x1, R * x1 + C * x0
            f2, f1 = f1, f(x1)
        probes += 1
    return (x1 if f1 < f2 else x2), probes


def ksize(points: torch.Tensor, tol: float, dtype=torch.float64):
    """Per-dim LOOCV bandwidths (standard deviations) of uniformly weighted
    ``points [n, d]``, each dim searched alone with its entropy in
    ``dtype``: ``(bw [d] list, probes [d] list)``."""
    n, d = points.shape
    w = torch.full((n,), 1.0 / n, dtype=dtype, device=points.device)
    bws, probes = [], []
    for k in range(d):
        row = points[:, k].to(dtype).contiguous()
        base, ax, bx, cx = bracket(row)
        a, m = golden(lambda x: loo_entropy(row, w, (base * x) ** 2),
                      ax, bx, cx, tol)
        bws.append(a * base)
        probes.append(m)
    return bws, probes
