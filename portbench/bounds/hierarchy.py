"""The level widths of the multiscale Gibbs product's hierarchy, from the
component counts alone (KernelDensityEstimate.jl's ball tree and
``levelDown!``, src/MSGibbs01.jl:500-523 and :660).

Level 0 is the root; each descent splits a slice of ``s >= 2`` points into
``ceil(s / 2)`` and ``floor(s / 2)``, and a leaf persists.  The product runs
``floor(log2(max(n_out, n_1, ...))) + 1`` levels."""

from __future__ import annotations

import math


def n_levels(n_out: int, npts) -> int:
    return int(math.floor(math.log2(float(max([n_out] + list(npts))))) + 1)


def level_sizes(n: int, levels: int):
    """For levels 1..``levels`` of an ``n``-point tree, ``{slice size:
    count}``."""
    cur, out = {n: 1}, []
    for _ in range(levels):
        nxt = {}
        for s, c in cur.items():
            for t in ((s + 1) // 2, s // 2) if s >= 2 else (1,):
                nxt[t] = nxt.get(t, 0) + c
        out.append(nxt)
        cur = nxt
    return out


def widths(n: int, levels: int):
    """Nodes at levels 1..``levels``, and whether every one is a leaf."""
    return [(sum(p.values()), set(p) == {1}) for p in level_sizes(n, levels)]
