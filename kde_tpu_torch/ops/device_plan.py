"""The product plan built on the densities' device, with no host tree
(ports ``kde_tpu/ops/device_plan.py:62-347``).

The Gibbs engine walks a level hierarchy: per level, the moment-matched
(mean, variance, weight) of every cluster of a median-split tree
(reference calcStatsDensity!, src/BallTreeDensity01.jl:141-187, walked by
levelDown!, src/MSGibbs01.jl:500-523).  The host plan
(``ops/gibbs.py::_ProductPlan``) builds it from a NumPy ball tree, which
copies a device-resident density (the output of an earlier product) to the
host and runs a Python quickselect.  For a fixed N the tree's structure is
data-independent -- slots, node slices, level lists and the bottom-up merge
schedule follow the recursion ``split = (lo + hi) // 2`` -- so only the
leaf permutation and the node statistics are computed here, on the device:

  depth k:  for every node slice, pick the most-spread coordinate (segment
            variance, argmax), then stable-sort positions by (slice id,
            coordinate): two ``torch.sort(stable=True)`` passes, first the
            coordinate, then the position-monotone slice id;

then a bottom-up moment-matching sweep.  Slices are contiguous position
ranges whose lengths differ by at most one at a depth, so the segment sums
are a padded gather and a plain sum: no ``index_add_``, whose atomics would
sum in a run-dependent order on CUDA.  The split statistics are summed in
float64, which keeps a near-tie from choosing another coordinate than a
float64 build would.

That eager build is the plan's CPU route and the plain twin of K8
(``ops/tree_build.py``): for CUDA tensors :func:`batched_device_plans`
hands the whole build (tree, slot arrays, level arrays) to K8's
hand-written kernels, a few launches in all.

Parity contract (as in the JAX package): in 1-D with distinct values the
hierarchy equals the host tree's; in d > 1 it is a statistically equivalent
median-split hierarchy (the host builder's exclude-last-leaf spread scan
depends on quickselect's element order).  Replay mode therefore always
takes the host plan.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from . import tree_build
from .balltree import NO_CHILD, level_lists, n_levels, pack_levels, topology
from .gibbs_chain import level_uniform

_EPS = float(np.finfo(np.float64).eps)


@functools.lru_cache(maxsize=128)
def _topology(n: int):
    """Static structure of an ``n``-point tree (host NumPy, cached):
    per depth, the slices that still split and their padded gather index;
    the bottom-up merge schedule; the tree's child arrays."""
    topo = topology(n)
    internal = np.asarray(sorted(s for _, _, s in topo.preorder))
    max_depth = int(topo.depth[internal].max())
    per_depth = []
    for k in range(max_depth + 1):
        g = internal[topo.depth[internal] == k]
        g = g[topo.highest_leaf[g] > topo.lowest_leaf[g]]
        if g.size == 0:
            per_depth.append(None)
            continue
        lo = np.sort(topo.lowest_leaf[g] - n)
        hi = np.sort(topo.highest_leaf[g] - n)
        count = hi - lo + 1
        idx = lo[:, None] + np.arange(int(count.max()))[None, :]
        valid = idx <= hi[:, None]
        # seg: slice ordinal of each covered position, -1 for positions
        # already at a leaf; sid: position-monotone slice id (slice start
        # for covered positions, own position for the others), so sorting
        # by it permutes within slices and moves nothing across them
        seg = np.full(n, -1, dtype=np.int64)
        seg[idx[valid]] = np.repeat(np.arange(g.size), count)
        sid = np.arange(n, dtype=np.int64)
        sid[idx[valid]] = np.repeat(lo, count)
        per_depth.append(dict(idx=np.where(valid, idx, lo[:, None]),
                              valid=valid, count=count.astype(np.float64),
                              seg=seg, sid=sid))
    merges = []
    for k in range(max_depth, -1, -1):
        g = internal[topo.depth[internal] == k]
        li = topo.left[g]
        ri = np.where(topo.right[g] == NO_CHILD, li, topo.right[g])
        merges.append((g, li, ri, li == ri))
    return dict(per_depth=per_depth, merges=merges, left=topo.left,
                right=topo.right)


@functools.lru_cache(maxsize=128)
def _topology_on(n: int, device: str):
    """:func:`_topology`'s index arrays as tensors on ``device``."""
    topo = _topology(n)
    dev = lambda x: torch.as_tensor(x, device=device)
    per_depth = [None if pd is None else {k: dev(v) for k, v in pd.items()}
                 for pd in topo["per_depth"]]
    merges = [tuple(dev(a) for a in m) for m in topo["merges"]]
    return per_depth, merges


def _pieces(n: int, levels: int):
    """The slice sizes of an ``n``-point tree at levels 0..``levels``, each
    a ``{size: count}`` dict: a slice of ``s >= 2`` points splits into
    ``ceil(s/2)`` and ``floor(s/2)`` (``balltree.topology``'s ``split =
    (lo + hi) // 2``), a leaf persists (``levelDown!``).  A level has at
    most two sizes besides 1, so this is O(levels) at any ``n``."""
    out = [{n: 1}]
    for _ in range(levels):
        nxt: dict = {}
        for s, c in out[-1].items():
            for t in ((s + 1) // 2, s // 2) if s >= 2 else (1,):
                nxt[t] = nxt.get(t, 0) + c
        out.append(nxt)
    return out


def level_widths(n: int, n_lv: int):
    """Nodes at levels 1..``n_lv`` of an ``n``-point tree (the lengths of
    :func:`_level_nodes`), counted from the slice sizes alone."""
    return [sum(p.values()) for p in _pieces(n, n_lv)[1:]]


def topology_bytes(n: int):
    """``(bytes, pad)`` of an ``n``-point tree's topology, counted from
    the slice sizes alone: the bytes of the index tensors
    :func:`_topology_on` uploads, and the largest padded slice gather (S
    slices x their widest, over the depths) of :func:`device_tree_stats`.
    Equal to the arrays of :func:`_topology`, which need not be built."""
    if n == 1:
        return 25, 1        # the lone root's merge; it never splits
    total = pad = 0
    for p in _pieces(n, n.bit_length()):
        split = {s: c for s, c in p.items() if s >= 2}
        if not split:
            continue
        s_k, l_max = sum(split.values()), max(split)
        # idx int64 and valid bool [S, Lmax], count float64 [S], seg and
        # sid int64 [n]; the merges' g, li, ri int64 and same bool [S]
        total += s_k * l_max * 9 + s_k * 8 + 16 * n + 25 * s_k
        pad = max(pad, s_k * l_max)
    return total, pad


def build_bytes(npts, d: int, itemsize: int, nodes: int,
                device=None) -> int:
    """Device memory a plan built here for densities of ``npts`` points in
    ``d`` dims (``itemsize``-byte floats, ``nodes`` level slots over all
    densities) takes beyond its own tensors.  On a CUDA ``device``, K8's
    workspace (``tree_build.workspace_bytes``); elsewhere the twin's: the
    topology index tensors cached on the device once per N
    (:func:`_topology_on`), the workspace of the widest density's
    :func:`device_tree_stats` and the temporaries of
    :func:`batched_device_plans`' assembly.  Both workspaces are counted
    whole, though the first is freed before the second is made.  Counted
    from the shapes alone, at any N."""
    if device is not None and torch.device(device).type == "cuda":
        return tree_build.workspace_bytes(npts, itemsize, nodes)
    topo = stats = 0
    for n in set(npts):
        t, pad = topology_bytes(n)
        topo += t
        # the stacked inputs (points, bw, weights) before and after their
        # cast, the order and the sort keys, values and indices
        vectors = n * ((2 * d + 1) * (8 + itemsize) + 8 * 8)
        # the split search: the float64 points and their padded slice
        # gather, masked copy, deviations and squares at the widest depth
        search = n * d * (itemsize + 8) + 4 * pad * d * 8
        # the statistics returned, and the previous density's still bound
        out = 2 * (2 * n * ((2 * d + 1) * itemsize + 8))
        stats = max(stats, vectors + search + out)
    # log weights of every slot; the slot indices, the padding row (float32
    # and cast), the gathered log weights and the uniform-level flags
    assembly = (len(npts) * 2 * max(npts) * itemsize
                + nodes * (8 + 4 + 2 * itemsize + d))
    return topo + stats + assembly


@functools.lru_cache(maxsize=128)
def _level_nodes(n: int, n_lv: int):
    """Static per-level slot lists (levelDown! semantics, leaves
    persisting), from the same child arrays as the host tree's."""
    topo = _topology(n)
    return level_lists(topo["left"], topo["right"], n, n_lv)


def device_tree_stats(points, var, w):
    """Flat tree statistics built on the tensors' device in eager ops: the
    plan's CPU route and the plain twin of K8 (``ops/tree_build.py``),
    which builds them for the main path on the card.

    ``points``/``var`` ``[..., N, d]`` and ``w`` ``[..., N]``, with an
    optional leading set axis.  Returns ``(means [..., 2N, d], bw [..., 2N,
    d], wts [..., 2N], perm [..., 2N])`` in the reference slot layout (root
    0, leaves N..2N-1; unused slots hold 0, 1, 0, 0)."""
    single = points.dim() == 2
    if single:
        points, var, w = points[None], var[None], w[None]
    b, n, d = points.shape
    per_depth, _ = _topology_on(n, str(points.device))
    order = torch.arange(n, device=points.device).expand(b, n).contiguous()
    for pd in per_depth:
        if pd is None:
            continue
        x = points.gather(1, order[..., None].expand(b, n, d))
        # unweighted variance per slice and dim, in float64
        xs = x.double()[:, pd["idx"]]                      # [B, S, Lmax, d]
        v = pd["valid"][None, :, :, None]
        mean = torch.where(v, xs, 0.0).sum(2) / pd["count"][:, None]
        dev = torch.where(v, xs - mean[:, :, None], 0.0)
        dim = (dev * dev).sum(2).argmax(-1)                # [B, S]
        covered = pd["seg"] >= 0
        dim_pos = torch.where(covered, dim[:, pd["seg"].clamp(min=0)], 0)
        keys = x.gather(2, dim_pos[..., None])[..., 0]     # [B, N]
        by_key = torch.sort(keys, dim=1, stable=True).indices
        by_sid = torch.sort(pd["sid"][by_key], dim=1, stable=True).indices
        order = order.gather(1, by_key.gather(1, by_sid))
    out = _tree_moments(points, var, w, order)
    return tuple(t[0] for t in out) if single else out


def _tree_moments(points, var, w, order):
    """The slot arrays of the tree whose leaf order is ``order [B, N]``
    (point index at each position) over ``points``/``var`` ``[B, N, d]``
    and ``w [B, N]``: the leaves, then the bottom-up moment sweep (reference
    calcStatsDensity!, src/BallTreeDensity01.jl:141-187), one vector step
    per depth.  Returns ``(means, bw, wts, perm)`` as
    :func:`device_tree_stats` does."""
    b, n, d = points.shape
    _, merges = _topology_on(n, str(points.device))
    means = points.new_zeros((b, 2 * n, d))
    bw = points.new_ones((b, 2 * n, d))
    wts = points.new_zeros((b, 2 * n))
    perm = torch.zeros((b, 2 * n), dtype=torch.int64, device=points.device)
    idx = order[..., None].expand(b, n, d)
    means[:, n:] = points.gather(1, idx)
    bw[:, n:] = var.gather(1, idx)
    wts[:, n:] = w.gather(1, order)
    perm[:, n:] = order
    for g, li, ri, same in merges:
        wl, wr = wts[:, li], wts[:, ri]
        tot = wl + wr + _EPS
        fl = (wl / tot)[..., None]
        fr = (wr / tot)[..., None]
        m = fl * means[:, li] + fr * means[:, ri]
        means[:, g] = m
        bw[:, g] = (fl * (bw[:, li] + means[:, li] ** 2)
                    + fr * (bw[:, ri] + means[:, ri] ** 2) - m ** 2)
        wts[:, g] = torch.where(same, wl, wl + wr)
    return means, bw, wts, perm


@functools.lru_cache(maxsize=64)
def _packed(npts, n_lv: int):
    return pack_levels([_level_nodes(n, n_lv) for n in npts], n_lv)


@functools.lru_cache(maxsize=64)
def _level_table(npts, n_lv: int, device: torch.device):
    """:func:`_packed`'s level table on ``device`` for K8's level launch,
    uploaded once: ``(offsets, nodes [dn, T] int32, valid [dn, T] uint8)``."""
    offsets, nodes, valid = _packed(npts, n_lv)
    return (offsets, torch.as_tensor(nodes, dtype=torch.int32, device=device),
            torch.as_tensor(valid, dtype=torch.uint8, device=device))


def batched_device_plans(density_sets, n_out: int, dtype):
    """Plan arrays of ``B`` same-shaped density sets, built in one pass on
    their device (the BatchedProductSampler build and refresh path: every
    belief-propagation iteration swaps in fresh message densities).

    Returns ``(t_mean, t_bw, lvl_mean, lvl_bw, lvl_logw, lvl_perm,
    offsets, n_levels, lvl_uniform)``, every tensor with a leading set axis:
    ``t_*`` ``[B, dn, 2 maxN, ...]``, ``lvl_*`` ``[B, dn, T, ...]``,
    ``lvl_uniform [B, dn, L, d]`` (``gibbs_chain.level_uniform``).  CUDA
    tensors take K8 (:func:`_kernel_arrays`), others the eager build
    (:func:`_eager_arrays`)."""
    sets = [list(ds) for ds in density_sets]
    npts = tuple(p.npts for p in sets[0])
    n_lv = n_levels(n_out, npts)
    build = (_kernel_arrays if sets[0][0].device.type == "cuda"
             else _eager_arrays)
    *arrays, uniform = build(sets, npts, n_lv, dtype)
    return (*arrays, list(_packed(npts, n_lv)[0]), n_lv, uniform)


def _kernel_arrays(sets, npts, n_lv: int, dtype):
    """:func:`batched_device_plans`' tensors from one K8 build
    (``tree_build.launch``): a lone set's densities are read in place
    (cast first where their dtype is not ``dtype``), ``B`` sets stacked a
    density at a time."""
    device = sets[0][0].device

    def density(j, attr):
        if len(sets) == 1:
            return getattr(sets[0][j], attr).to(dtype).contiguous()[None]
        return torch.stack([getattr(s[j], attr) for s in sets]).to(dtype)

    ins = [tuple(density(j, a) for a in ("points", "bw", "weights"))
           for j in range(len(npts))]
    out = tree_build.launch(ins, dtype, 2 * max(npts),
                            _level_table(npts, n_lv, device))
    return tuple(out[k] for k in ("t_mean", "t_bw", "lvl_mean", "lvl_bw",
                                  "lvl_logw", "lvl_perm", "lvl_uniform"))


def _eager_arrays(sets, npts, n_lv: int, dtype):
    """:func:`batched_device_plans`' tensors in eager ops on any device:
    each density's :func:`device_tree_stats` over the stacked sets, then
    the slot arrays and the level arrays (K8's twin)."""
    dn, d = len(sets[0]), sets[0][0].ndim
    device = sets[0][0].device
    offsets, nodes, valid = _packed(npts, n_lv)
    b, two_n = len(sets), 2 * max(npts)
    t_mean = torch.zeros((b, dn, two_n, d), dtype=dtype, device=device)
    t_bw = torch.ones((b, dn, two_n, d), dtype=dtype, device=device)
    t_logw = torch.full((b, dn, two_n), -np.inf, dtype=dtype, device=device)
    t_perm = torch.zeros((b, dn, two_n), dtype=torch.int64, device=device)
    for j in range(dn):
        stack = lambda attr: torch.stack(
            [getattr(s[j], attr) for s in sets]).to(dtype)
        m, bw, wt, pm = device_tree_stats(stack("points"), stack("bw"),
                                          stack("weights"))
        s = 2 * npts[j]
        t_mean[:, j, :s] = m
        t_bw[:, j, :s] = bw
        # floor at the dtype's tiny, not at 1e-300: in float32 that literal
        # is 0, and a zero-weight kernel would get logw = -inf and flip the
        # degenerate-fallback predicate against the host plan
        t_logw[:, j, :s] = torch.log(wt.clamp_min(torch.finfo(dtype).tiny))
        t_perm[:, j, :s] = pm
    jj = torch.arange(dn, device=device)[:, None]
    nodes = torch.as_tensor(nodes, device=device)
    pad = torch.where(torch.as_tensor(valid, device=device), 0.0, -np.inf)
    lvl_bw = t_bw[:, jj, nodes]
    return (t_mean, t_bw, t_mean[:, jj, nodes], lvl_bw,
            t_logw[:, jj, nodes] + pad.to(dtype), t_perm[:, jj, nodes],
            level_uniform(lvl_bw, offsets))


class DeviceProductPlan:
    """The plan of one density set built on its device: the consuming
    interface of ``ops/gibbs.py::_ProductPlan`` (``ndens``, ``ndim``,
    ``n_levels``, ``offsets``, ``t_mean``/``t_bw`` ``[dn, 2N, d]``,
    ``lvl_mean``/``lvl_bw`` ``[dn, T, d]``, ``lvl_logw``/``lvl_perm``
    ``[dn, T]``, ``lvl_uniform [dn, L, d]``) with no host tree and no copy
    to the host."""

    def __init__(self, densities: Sequence, n_out: int, dtype):
        dims = {p.ndim for p in densities}
        if len(dims) != 1:
            raise ValueError("kdes must have same dimension "
                             "(reference src/MSGibbs01.jl:721)")
        self.ndens, self.ndim = len(densities), dims.pop()
        (t_mean, t_bw, lvl_mean, lvl_bw, lvl_logw, lvl_perm, self.offsets,
         self.n_levels, uniform) = batched_device_plans([densities], n_out,
                                                        dtype)
        self.lvl_uniform = uniform[0]
        self.t_mean, self.t_bw = t_mean[0], t_bw[0]
        self.lvl_mean, self.lvl_bw = lvl_mean[0], lvl_bw[0]
        self.lvl_logw, self.lvl_perm = lvl_logw[0], lvl_perm[0]
