"""Flat ball-tree construction in NumPy (ports the Python builder of
``kde_tpu/ops/balltree.py:52-350`` and ``neighbor_min_max``).

The port carries its own copy because the package never imports
``kde_tpu`` (whose ``__init__`` imports JAX).  The builder must stay
**bit-identical** to ``kde_tpu``'s: the golden fixtures and the trace-exact
replay of the Gibbs product both depend on the exact leaf arrangement
(tests/test_torch_balltree.py compares the two array for array).  Trees
of more than one point are built in C++ by default (``backend="auto"``,
``csrc/balltree.cpp`` through ``kde_tpu_torch/native.py``), which gives
the same arrays (tests/test_torch_native_balltree.py); ``backend="python"``
is the NumPy builder, the plain twin.

Layout: ``2N`` slots, 0-based; internal nodes in slots ``0..N-2`` (root 0),
leaves in ``N..2N-1`` -- the layout of the reference's golden dumps
(reference src/BallTree01.jl:10-28, src/BallTreeDensity01.jl:11-24).

Algorithms, with the reference's quirks kept for bit-parity:
  * split dimension = coordinate of max variance over the leaf slice
    *excluding its last leaf*, weight ``1/(high-low)``
    (reference src/BallTree01.jl:142-173);
  * median split by quickselect, Lomuto partition, middle pivot
    (reference src/BallTree01.jl:223-242);
  * bottom-up box and moment-matched Gaussian statistics per node
    (reference src/BallTree01.jl:282-336, src/BallTreeDensity01.jl:141-187).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import native

NO_CHILD = -1

# reference src/BallTreeDensity01.jl:161: `wtT = wtL + wtR + eps(Float64)`
_EPS = np.finfo(np.float64).eps


@dataclasses.dataclass
class FlatBallTree:
    """Flat-array ball tree with Gaussian sufficient statistics per node
    (NumPy float64 / int64, ``2N`` slots; ``bandwidth`` is a variance)."""

    dims: int
    num_points: int
    centers: np.ndarray      # [2N, d]
    ranges: np.ndarray       # [2N, d]
    weights: np.ndarray      # [2N]
    left: np.ndarray         # [2N] int
    right: np.ndarray        # [2N] int
    lowest_leaf: np.ndarray  # [2N] int
    highest_leaf: np.ndarray # [2N] int
    permutation: np.ndarray  # [2N] int; leaf slot -> original point index
    means: np.ndarray        # [2N, d]
    bandwidth: np.ndarray    # [2N, d] (variance)
    bw_min: np.ndarray       # [2N, d] if multibandwidth else [d]
    bw_max: np.ndarray       # [2N, d] if multibandwidth else [d]
    multibandwidth: bool
    depth: np.ndarray        # [2N] int; root 0, unused slots -1

    @property
    def root(self) -> int:
        return 0

    def level_lists(self, n_levels: int) -> List[np.ndarray]:
        """Node sets per level (see :func:`level_lists`)."""
        return level_lists(self.left, self.right, self.num_points, n_levels)


def level_lists(left: np.ndarray, right: np.ndarray, num_points: int,
                n_levels: int) -> List[np.ndarray]:
    """Node sets per level as the reference's ``levelDown!`` produces them
    (reference src/MSGibbs01.jl:500-523): level 0 is the root, each descent
    replaces every node by its valid children, leaves persist.  Returns
    ``n_levels + 1`` arrays."""
    two_n = 2 * num_points
    out = [np.array([0], dtype=np.int64)]
    cur = out[0]
    for _ in range(n_levels):
        pairs = np.stack([left[cur], right[cur]], axis=1).ravel()
        cur = pairs[(pairs >= 0) & (pairs < two_n)]
        out.append(cur)
    return out


def n_levels(n_out: int, npts: Sequence[int]) -> int:
    """Nlevels = floor(log2(maxNp)) + 1 (reference src/MSGibbs01.jl:660)."""
    max_np = max([n_out] + list(npts))
    return int(math.floor(math.log(float(max_np)) / math.log(2.0)) + 1.0)


def pack_levels(per_tree: Sequence[List[np.ndarray]], n_lv: int):
    """Pad the per-level node lists of ``dn`` trees across trees and pack
    levels 1..n_lv along one node axis: returns ``offsets`` (level ``l`` is
    the slice ``offsets[l-1] = (start, width)``), ``nodes [dn, T]`` and
    ``valid [dn, T]``.  Padded slots repeat the level's last valid node
    (and get a -inf log-weight from the caller): a CDF tail that overflows
    into the padding selects the last valid node, the reference's
    fall-to-last-entry rule (src/MSGibbs01.jl:330-351)."""
    dn = len(per_tree)
    offsets: List[Tuple[int, int]] = []
    total = 0
    for l in range(1, n_lv + 1):
        w = max(len(per_tree[j][l]) for j in range(dn))
        offsets.append((total, w))
        total += w
    nodes = np.zeros((dn, total), dtype=np.int64)
    valid = np.zeros((dn, total), dtype=bool)
    for l in range(1, n_lv + 1):
        o, w = offsets[l - 1]
        for j in range(dn):
            lst = per_tree[j][l]
            nodes[j, o:o + len(lst)] = lst
            valid[j, o:o + len(lst)] = True
            nodes[j, o + len(lst):o + w] = lst[-1]
    return offsets, nodes, valid


@dataclasses.dataclass
class Topology:
    """The data-independent structure of an ``N``-point tree: the median
    split at ``(lo + hi) // 2`` depends only on ``N`` (reference
    src/BallTree01.jl:342-411).  ``preorder`` lists ``(lo, hi, slot)`` of
    every internal node in the order the builder splits them; the arrays
    are as in :class:`FlatBallTree`."""

    left: np.ndarray
    right: np.ndarray
    lowest_leaf: np.ndarray
    highest_leaf: np.ndarray
    depth: np.ndarray
    preorder: List[Tuple[int, int, int]]


def topology(N: int) -> Topology:
    """Slot allocation by iterative DFS mirroring the reference's recursion:
    child slots are allocated before recursing (left first), ``next``
    starts at slot 1; leaves are slots ``N..2N-1``."""
    two_n = 2 * N
    left = np.zeros(two_n, dtype=np.int64)
    right = np.zeros(two_n, dtype=np.int64)
    lowest = np.zeros(two_n, dtype=np.int64)
    highest = np.zeros(two_n, dtype=np.int64)
    depth = np.full(two_n, -1, dtype=np.int64)
    preorder: List[Tuple[int, int, int]] = []
    next_slot = 1
    stack: List[Tuple[int, int, int, int]] = [(0, N - 1, 0, 0)]
    while stack:
        lo, hi, slot, dep = stack.pop()
        depth[slot] = dep
        lowest[slot] = N + lo
        highest[slot] = N + hi
        preorder.append((lo, hi, slot))
        if lo == hi:
            # single-point tree (N == 1 at the root)
            left[slot] = N + lo
            right[slot] = NO_CHILD
            continue
        split = (lo + hi) // 2
        if split <= lo:
            lslot = N + lo
        else:
            lslot = next_slot
            next_slot += 1
        if split + 1 >= hi:
            rslot = N + hi
        else:
            rslot = next_slot
            next_slot += 1
        left[slot] = lslot
        right[slot] = rslot
        if rslot < N:
            stack.append((split + 1, hi, rslot, dep + 1))
        else:
            depth[rslot] = dep + 1
        if lslot < N:
            stack.append((lo, split, lslot, dep + 1))
        else:
            depth[lslot] = dep + 1
    leaf_slots = np.arange(N, two_n)
    lowest[leaf_slots] = leaf_slots
    highest[leaf_slots] = leaf_slots
    left[leaf_slots] = leaf_slots
    right[leaf_slots] = NO_CHILD
    return Topology(left, right, lowest, highest, depth, preorder)


def _most_spread_dim(pts: np.ndarray, order: np.ndarray, low: int,
                     high: int) -> int:
    """Dimension of maximum variance over leaf positions ``low..high-1``
    with weight ``1/(high-low)`` (the reference's indexing quirk)."""
    idx = order[low:high]
    if idx.size == 0:
        return 0
    w = 1.0 / (high - low)
    x = pts[idx]
    mean = (w * x).sum(axis=0)
    var = ((x - mean) ** 2).sum(axis=0)
    return int(np.argmax(var))


def _select(pts: np.ndarray, order: np.ndarray, dim: int, position: int,
            low: int, high: int) -> None:
    """Quickselect (Lomuto partition, middle-element pivot) placing the
    element of rank ``position`` along ``pts[:, dim]`` at
    ``order[position]``."""
    col = pts[:, dim]
    while low < high:
        r = (low + high) // 2
        order[r], order[low] = order[low], order[r]
        pivot = col[order[low]]
        m = low
        for i in range(low, high + 1):
            if col[order[i]] < pivot:
                m += 1
                order[m], order[i] = order[i], order[m]
        order[low], order[m] = order[m], order[low]
        if m <= position:
            low = m + 1
        if m >= position:
            high = m - 1


def build_balltree(points: np.ndarray,
                   weights: np.ndarray,
                   bandwidth: Optional[np.ndarray] = None,
                   backend: str = "auto") -> FlatBallTree:
    """Build the flat ball tree + Gaussian stats for ``points [N, d]``.

    ``bandwidth``: kernel variances, ``[d]`` (uniform) or ``[N, d]``
    (multi-bandwidth); ``None`` gives zeros.  ``backend``: ``"auto"`` and
    ``"native"`` build in C++ when ``N > 1`` (a failed build raises),
    ``"python"`` with NumPy; all give the same arrays."""
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"backend must be 'auto', 'native' or 'python'; "
                         f"got {backend!r}")
    pts = np.ascontiguousarray(np.asarray(points, dtype=np.float64))
    if pts.ndim != 2:
        raise ValueError("points must be [N, d]")
    N, d = pts.shape
    w = np.ascontiguousarray(np.asarray(weights, dtype=np.float64).reshape(N))

    if bandwidth is None:
        bw_leaf = np.zeros((N, d))
        multibw = False
        bw1d = np.zeros(d)
    else:
        bwa = np.asarray(bandwidth, dtype=np.float64)
        if bwa.ndim == 1:
            multibw = False
            bw1d = bwa.reshape(d).copy()
            bw_leaf = np.tile(bw1d, (N, 1))
        else:
            multibw = True
            bw1d = None
            bw_leaf = np.ascontiguousarray(bwa.reshape(N, d))

    if backend != "python" and N > 1:
        return _build_native(pts, w, bw_leaf, multibw, bw1d)

    two_n = 2 * N
    centers = np.zeros((two_n, d))
    ranges = np.zeros((two_n, d))
    wts = np.zeros(two_n)
    perm = np.zeros(two_n, dtype=np.int64)
    means = np.zeros((two_n, d))
    bw_arr = np.zeros((two_n, d))

    # split every internal node in the builder's preorder: a node's
    # quickselect runs before its children's, on its own leaf range
    topo = topology(N)
    order = np.arange(N)
    for lo, hi, _ in topo.preorder:
        if lo < hi:
            dim = _most_spread_dim(pts, order, lo, hi)
            _select(pts, order, dim, (lo + hi) // 2, lo, hi)
    left, right, depth = topo.left, topo.right, topo.depth
    lowest, highest = topo.lowest_leaf, topo.highest_leaf

    # leaves (reference src/BallTree01.jl:415-429 + density overlay)
    leaf_slots = np.arange(N, two_n)
    centers[leaf_slots] = pts[order]
    means[leaf_slots] = pts[order]
    wts[leaf_slots] = w[order]
    bw_arr[leaf_slots] = bw_leaf[order]
    perm[leaf_slots] = order

    if multibw:
        bw_min = np.zeros((two_n, d))
        bw_max = np.zeros((two_n, d))
        bw_min[leaf_slots] = bw_leaf[order]
        bw_max[leaf_slots] = bw_leaf[order]
    else:
        bw_min = bw1d
        bw_max = bw1d

    # bottom-up statistics, vectorized per depth level
    internal = np.asarray(sorted(slot for _, _, slot in topo.preorder),
                          dtype=np.int64)
    for dep in (range(int(depth[internal].max()), -1, -1)
                if internal.size else []):
        g = internal[depth[internal] == dep]
        if g.size == 0:
            continue
        li = left[g]
        ri = right[g]
        ri_eff = np.where(ri == NO_CHILD, li, ri)  # N==1 root: single child
        cl, rl = centers[li], ranges[li]
        cr, rr = centers[ri_eff], ranges[ri_eff]
        maxi = np.maximum(cl + rl, cr + rr)
        mini = np.minimum(cl - rl, cr - rr)
        half = (maxi - mini) / 2.0
        ranges[g] = half
        centers[g] = mini + half
        wl = wts[li]
        wr = wts[ri_eff]
        wts[g] = np.where(li == ri_eff, wl, wl + wr)
        wt_t = wl + wr + _EPS
        fl = (wl / wt_t)[:, None]
        fr = (wr / wt_t)[:, None]
        m = fl * means[li] + fr * means[ri_eff]
        means[g] = m
        bw_arr[g] = (fl * (bw_arr[li] + means[li] ** 2)
                     + fr * (bw_arr[ri_eff] + means[ri_eff] ** 2)
                     - m ** 2)
        if multibw:
            bw_max[g] = np.maximum(bw_max[li], bw_max[ri_eff])
            bw_min[g] = np.minimum(bw_min[li], bw_min[ri_eff])

    return FlatBallTree(
        dims=d, num_points=N,
        centers=centers, ranges=ranges, weights=wts,
        left=left, right=right, lowest_leaf=lowest, highest_leaf=highest,
        permutation=perm, means=means, bandwidth=bw_arr,
        bw_min=bw_min, bw_max=bw_max, multibandwidth=multibw, depth=depth,
    )


def _build_native(pts: np.ndarray, w: np.ndarray, bw_leaf: np.ndarray,
                  multibw: bool, bw1d: Optional[np.ndarray]) -> FlatBallTree:
    """The C++ builder (``csrc/balltree.cpp``): the arrays of the NumPy
    path above, with ``bw_min``/``bw_max`` ``[d]`` for a uniform bandwidth
    and unused depth slots -1 (ports ``kde_tpu/ops/balltree.py:353-395``)."""
    import ctypes
    lib = native.get_lib()
    N, d = pts.shape
    two_n = 2 * N
    f64 = lambda *shape: np.zeros(shape)
    i64 = lambda: np.zeros(two_n, dtype=np.int64)
    centers, ranges, means, bw_arr = (f64(two_n, d) for _ in range(4))
    wts = f64(two_n)
    left, right, lowest, highest, perm, depth = (i64() for _ in range(6))
    # bw_min/bw_max are read and written only for a multi-bandwidth tree
    bw_min, bw_max = ((f64(two_n, d), f64(two_n, d)) if multibw
                      else (f64(1, d), f64(1, d)))
    dp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    lib.kde_build_balltree(
        dp(pts), dp(w), dp(np.ascontiguousarray(bw_leaf)), N, d,
        int(multibw), dp(centers), dp(ranges), dp(wts), ip(left), ip(right),
        ip(lowest), ip(highest), ip(perm), dp(means), dp(bw_arr),
        dp(bw_min), dp(bw_max), ip(depth))
    native.BUILDS += 1
    return FlatBallTree(
        dims=d, num_points=N,
        centers=centers, ranges=ranges, weights=wts,
        left=left, right=right, lowest_leaf=lowest, highest_leaf=highest,
        permutation=perm, means=means, bandwidth=bw_arr,
        bw_min=bw_min if multibw else bw1d,
        bw_max=bw_max if multibw else bw1d,
        multibandwidth=multibw, depth=depth)


def neighbor_min_max(tree: FlatBallTree) -> Tuple[float, float]:
    """LOOCV bracket ``[minm, maxm]`` from the tree geometry (reference
    src/CrossValidation.jl:100-108): the root box diagonal and the smallest
    internal-node box diagonal, floored at 1e-6."""
    N = tree.num_points
    if N < 2:
        return 1e-6, 1e-6
    rang = tree.ranges[0:N - 1]
    diag = np.sqrt(((2.0 * rang) ** 2).sum(axis=1))
    maxm = float(diag[0])
    minm = float(max(diag.min(), 1e-6))
    return minm, maxm
