"""Flat ball-tree construction in NumPy (ports the Python builder of
``kde_tpu/ops/balltree.py:52-350`` and ``neighbor_min_max``).

The port carries its own copy because the package never imports
``kde_tpu`` (whose ``__init__`` imports JAX).  The builder must stay
**bit-identical** to ``kde_tpu``'s: the golden fixtures and the trace-exact
replay of the Gibbs product both depend on the exact leaf arrangement
(tests/test_torch_balltree.py compares the two array for array).

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
from typing import List, Optional, Tuple

import numpy as np

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
        """Node sets per level as the reference's ``levelDown!`` produces
        them (reference src/MSGibbs01.jl:500-523): level 0 is the root, each
        descent replaces every node by its valid children, leaves persist.
        Returns ``n_levels + 1`` arrays."""
        two_n = 2 * self.num_points
        out = [np.array([self.root], dtype=np.int64)]
        cur = out[0]
        for _ in range(n_levels):
            pairs = np.stack([self.left[cur], self.right[cur]], axis=1).ravel()
            cur = pairs[(pairs >= 0) & (pairs < two_n)]
            out.append(cur)
        return out


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
                   bandwidth: Optional[np.ndarray] = None) -> FlatBallTree:
    """Build the flat ball tree + Gaussian stats for ``points [N, d]``.

    ``bandwidth``: kernel variances, ``[d]`` (uniform) or ``[N, d]``
    (multi-bandwidth); ``None`` gives zeros."""
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

    two_n = 2 * N
    centers = np.zeros((two_n, d))
    ranges = np.zeros((two_n, d))
    wts = np.zeros(two_n)
    left = np.zeros(two_n, dtype=np.int64)
    right = np.zeros(two_n, dtype=np.int64)
    lowest = np.zeros(two_n, dtype=np.int64)
    highest = np.zeros(two_n, dtype=np.int64)
    perm = np.zeros(two_n, dtype=np.int64)
    means = np.zeros((two_n, d))
    bw_arr = np.zeros((two_n, d))
    depth = np.full(two_n, -1, dtype=np.int64)

    order = np.arange(N)

    # topology by iterative DFS mirroring the reference's recursion
    # (reference src/BallTree01.jl:342-411): child slots are allocated
    # before recursing (left first); `next` starts at slot 1
    next_slot = 1
    stack: List[Tuple[int, int, int, int]] = [(0, N - 1, 0, 0)]
    internal_nodes: List[int] = []
    while stack:
        lo, hi, slot, dep = stack.pop()
        depth[slot] = dep
        if lo == hi:
            # single-point tree (N == 1 at the root)
            lowest[slot] = N + lo
            highest[slot] = N + hi
            left[slot] = N + lo
            right[slot] = NO_CHILD
            internal_nodes.append(slot)
            continue
        dim = _most_spread_dim(pts, order, lo, hi)
        split = (lo + hi) // 2
        _select(pts, order, dim, split, lo, hi)
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
        lowest[slot] = N + lo
        highest[slot] = N + hi
        left[slot] = lslot
        right[slot] = rslot
        internal_nodes.append(slot)
        if rslot < N:
            stack.append((split + 1, hi, rslot, dep + 1))
        else:
            depth[rslot] = dep + 1
        if lslot < N:
            stack.append((lo, split, lslot, dep + 1))
        else:
            depth[lslot] = dep + 1

    # leaves (reference src/BallTree01.jl:415-429 + density overlay)
    leaf_slots = np.arange(N, two_n)
    centers[leaf_slots] = pts[order]
    means[leaf_slots] = pts[order]
    wts[leaf_slots] = w[order]
    bw_arr[leaf_slots] = bw_leaf[order]
    perm[leaf_slots] = order
    lowest[leaf_slots] = leaf_slots
    highest[leaf_slots] = leaf_slots
    left[leaf_slots] = leaf_slots
    right[leaf_slots] = NO_CHILD

    if multibw:
        bw_min = np.zeros((two_n, d))
        bw_max = np.zeros((two_n, d))
        bw_min[leaf_slots] = bw_leaf[order]
        bw_max[leaf_slots] = bw_leaf[order]
    else:
        bw_min = bw1d
        bw_max = bw1d

    # bottom-up statistics, vectorized per depth level
    internal = np.asarray(internal_nodes, dtype=np.int64)
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
