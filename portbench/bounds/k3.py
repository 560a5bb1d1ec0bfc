"""The least time of the Gibbs chains of one product call (K3's work),
counted from the call's shapes alone.

Per chain, per level and per density: one conditioning selection (the
candidates scored against the drawn point, each with its own bandwidth) and
``n_iter`` sweep selections (scored against the product of the other
densities' picks).  Per (selection, candidate) with ``k`` active dims: k IEEE
divisions (a reciprocal each on the SFU), the exp of the inverse CDF, and
5k + 5 FP32 operations (difference, square, scale, log add, accumulate;
weight, max, shift, sum).  The logs of the variance sums: on a sweep, k a
pair, or one a selection on a level of leaves, which has one bandwidth a dim
(every configuration's beliefs have one bandwidth a dim); on the
conditioning step the candidate's own bandwidth, which no chain changes, so
k a (set, density, candidate), or one a (set, density) on a level of
leaves.  Bytes: the level arrays and the random streams read once, points
and labels written once."""

from __future__ import annotations

from . import hierarchy
from .roofline import least_seconds


def chain_seconds(sets: int, npts, d: int, n_out: int, n_iter: int,
                  itemsize: int) -> float:
    dn = len(npts)
    levels = hierarchy.n_levels(n_out, npts)
    k = d
    chains = sets * n_out
    sfu = fp32 = 0.0
    nodes = 0
    for j in range(dn):
        for w, leaves in hierarchy.widths(npts[j], levels):
            ku = k if leaves else 0
            nodes += w
            sweep = n_iter * chains
            sfu += sweep * (w * (2 * k + 1 - ku) + ku)
            sfu += chains * w * (k + 1) + sets * (w * (k - ku) + ku)
            fp32 += (1 + n_iter) * chains * w * (5 * k + 5)
    streams = chains * (dn * (1 + levels * (1 + n_iter)) + d * (levels + 1))
    nbytes = (sets * nodes * ((2 * d + 1) * itemsize + 8)
              + streams * itemsize
              + chains * (d * itemsize + 8 * dn * (levels + 1)))
    return least_seconds(nbytes, sfu=sfu, fp32=fp32)
