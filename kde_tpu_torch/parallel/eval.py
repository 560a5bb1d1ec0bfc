"""Sharded density evaluation and LOOCV reductions (ports
``kde_tpu/parallel/eval.py:37-205``).

Over a ``chains x kernels`` mesh: query rows split over ``chains``,
mixture components over ``kernels``; the weighted log-sum-exp over
components becomes a ``pmax`` of the shard maxima and a ``psum`` of the
shifted sums, and the LOO entropy adds a ``psum`` over ``chains`` of the
per-query terms (SURVEY §5: the only places the framework needs
communication).  The LOOCV search splits its queries over the whole mesh
with every column on each rank, so it needs one ``psum`` a sweep over all
the mesh's ranks and nothing else.  Every rank passes the same
full inputs and works on its own query and component rows, on the device
of the first input (a CUDA tensor stays on the card whatever the backend;
NumPy input goes to ``config.DEVICE``, the card by default).  An axis the
mesh lacks counts as size 1; the row counts must divide the axes (pad with
zero-weight components), except in :func:`ksize_bandwidths_sharded`,
which pads.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import DeviceMesh

from .. import config
from ..ops import kernels, sharded_loo
from ..ops.loocv import _slices_on, bracket_rows
from .collectives import gather_rows, pmax, psum
from .mesh import CHAINS, KERNELS, axis_index, axis_size


def _rows(mesh: DeviceMesh, axis: str, n: int) -> slice:
    s = axis_size(mesh, axis)
    if n % s:
        raise ValueError(f"{n} rows do not divide the '{axis}' axis of size "
                         f"{s}; pad them (zero-weight components)")
    i = axis_index(mesh, axis)
    return slice(i * (n // s), (i + 1) * (n // s))


def _local(x, rows: slice, dev) -> torch.Tensor:
    return torch.as_tensor(x)[rows].to(dev).contiguous()


def _lse_over_kernels(v: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``log sum_shards exp(v)``, rowwise: ``pmax`` then ``psum`` of the
    shifted exponentials; a row that is -inf on every shard stays -inf."""
    m = pmax(v, mesh, KERNELS)
    ms = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    return ms + torch.log(psum(torch.exp(v - ms), mesh, KERNELS))


def sharded_log_eval(mesh: DeviceMesh, query, means, var,
                     weights) -> torch.Tensor:
    """``log p`` at each query row (``[M, d]`` queries, ``[N, d]``
    means/variances, ``[N]`` weights), queries split over ``chains`` and
    components over ``kernels``.  Each shard's part is
    ``kernels.log_eval_gated`` on its components (the tiled kernel K1 above
    ``config.DIRECT_PAIR_LIMIT`` pairs in float32), which sums unnormalized
    ``w_n`` terms, so the shard values combine by log-sum-exp.  Returns
    ``[M]``, gathered, on the queries' device (``config.DEVICE`` for
    NumPy queries)."""
    dev = config.input_device(query)
    qr = _rows(mesh, CHAINS, query.shape[0])
    kr = _rows(mesh, KERNELS, means.shape[0])
    q = _local(query, qr, dev)
    v = kernels.log_eval_gated(q, _local(means, kr, dev),
                               _local(var, kr, dev),
                               _local(weights, kr, dev))
    return gather_rows(_lse_over_kernels(v, mesh), mesh, CHAINS,
                       query.shape[0])


def _entropy_terms(logp, qw, mesh: DeviceMesh):
    """``-sum_j w_j log p_j`` over every chain shard's queries, +inf if a
    positive-weight query has zero likelihood (the guard of
    ``kernels.eval_avg_logl_from_logp``); ``logp``/``qw`` ``[R, m]`` give
    ``[R]``."""
    pos = qw > 0
    zero = torch.zeros_like(logp)
    h = -torch.where(pos, qw * torch.where(pos, logp, zero), zero).sum(dim=-1)
    bad = (torch.isneginf(logp) & pos).to(logp.dtype).sum(dim=-1)
    hb = psum(torch.stack([h, bad]), mesh, CHAINS)
    return torch.where(hb[1] > 0, torch.full_like(hb[0], math.inf), hb[0])


def sharded_loo_entropy(mesh: DeviceMesh, points, var,
                        weights) -> torch.Tensor:
    """Leave-one-out entropy with the ``N x N`` pairs split over both axes:
    each shard's rows are ``kernels.log_eval_gated`` of its components with
    the diagonal mask offset by the shard's row start minus its column
    start (above ``config.DIRECT_PAIR_LIMIT`` local pairs the tiled kernel
    K1 in float32, else query blocks within the limit, so no shard builds
    more than the limit's logits), combined over ``kernels`` by a ``pmax``
    and a ``psum`` as in :func:`sharded_log_eval`, then summed over
    ``chains`` by a ``psum``.  That takes the log-sum-exp of each shard
    before the ``pmax``, where the JAX package takes the ``pmax`` of the
    logits' maxima: within rtol 1e-10 of it in float64 and 1e-5 in
    float32 (tests/test_torch_sharding.py).  Returns a scalar on the
    points' device."""
    dev = config.input_device(points)
    n = points.shape[0]
    qr, kr = _rows(mesh, CHAINS, n), _rows(mesh, KERNELS, n)
    qw = _local(weights, qr, dev)
    v = kernels.log_eval_gated(
        _local(points, qr, dev),
        *(_local(x, kr, dev) for x in (points, var, weights)),
        loo_diag=qr.start - kr.start)
    logp = _lse_over_kernels(v, mesh) - torch.log1p(-qw)
    return _entropy_terms(logp[None], qw[None], mesh)[0]


def ksize_bandwidths_sharded(mesh: DeviceMesh, points, weights=None,
                             tol: float = 1e-2, dtype=None) -> torch.Tensor:
    """LOOCV bandwidth selection with each probe's per-dimension
    ``[N, N]`` LOO entropies split over the whole mesh: the golden search
    of ``ops/loocv.py`` (brackets, probes, updates) runs on every rank with
    replicated state, as ``ops/sharded_loo.py::search`` (on the card the
    kernels K7, one launch a sweep, with no ``[N/S, N]`` temporary and no
    host read of the sweep just issued).  The padded query rows are split
    over all ``chains x kernels`` ranks in a flat, chains-major order, and
    every rank holds all ``N`` columns: a query's sum is whole on its rank,
    so a sweep issues one ``psum`` of its ``[rows, 2]`` entropies over
    every rank (``lax.psum(x, (CHAINS, KERNELS))``) and every rank takes the
    same branch.  ``N`` is padded to the mesh with zero-weight query rows,
    which add nothing.  Same selection as ``ksize_bandwidths`` up to the
    order of the sums.  Returns ``[d]`` std-dev bandwidths on the points'
    device."""
    dev = config.input_device(points)
    points = torch.as_tensor(points, dtype=dtype, device=dev)
    n, d = points.shape
    if weights is None:
        w = torch.full((n,), 1.0 / n, dtype=points.dtype, device=dev)
    else:
        w = torch.as_tensor(weights, dtype=points.dtype).to(dev)
        w = w / w.sum()
    base, ax, bx, cx = bracket_rows(points.T.contiguous(), *_slices_on(n, dev))
    nk = axis_size(mesh, KERNELS)
    ranks = axis_size(mesh, CHAINS) * nk
    m = -(-n // ranks)
    q0 = (axis_index(mesh, CHAINS) * nk + axis_index(mesh, KERNELS)) * m
    pts_p = torch.nn.functional.pad(points, (0, 0, 0, m * ranks - n))
    w_p = torch.nn.functional.pad(w, (0, m * ranks - n))
    return sharded_loo.search(
        pts_p[q0:q0 + m], w_p[q0:q0 + m], points, w, base, ax, bx, cx,
        q0=q0, tol=float(tol),
        psum=lambda x: psum(x, mesh, (CHAINS, KERNELS), inplace=True))
