"""The least time of one device plan's build (K8's work), counted from the
plan's shapes alone, so that any implementation of the plan is held to the
same work.

A plan of ``sets`` sets of beliefs, the ``j``-th of ``npts[j]`` points in
``d`` dims, holds for every (set, belief) a median-split tree built to its
leaves (``hierarchy.py``'s rule: a slice of ``s >= 2`` points splits into
``ceil(s / 2)`` and ``floor(s / 2)``), the moment-matched node of each of
its ``2 n - 1`` slices (the slot arrays), and the nodes of the product's
levels 0 to ``hierarchy.n_levels`` (the level arrays).  Memory bound: each
depth at which a slice still splits reads the points once, and the slot
and level arrays are written once, a node its mean and bandwidth (``d``
floats each), its log weight and its 8-byte point index.  What the kernels
read again (sort keys, the moment sweep's inputs) is not counted."""

from __future__ import annotations

from . import hierarchy
from .roofline import least_seconds


def split_depths(n: int) -> int:
    """Depths of an ``n``-point tree at which some slice still splits."""
    sizes = [{n: 1}] + hierarchy.level_sizes(n, n.bit_length())
    return sum(max(p) >= 2 for p in sizes)


def plan_bytes(npts, d: int, n_out: int, itemsize: int) -> int:
    """Bytes one set's plan reads and writes at the least."""
    levels = hierarchy.n_levels(n_out, npts)
    node = (2 * d + 1) * itemsize + 8
    total = 0
    for n in npts:
        level_nodes = 1 + sum(w for w, _ in hierarchy.widths(n, levels))
        total += (split_depths(n) * n * d * itemsize
                  + (2 * n - 1 + level_nodes) * node)
    return total


def plan_seconds(sets: int, npts, d: int, n_out: int, itemsize: int) -> float:
    return least_seconds(sets * plan_bytes(npts, d, n_out, itemsize))
