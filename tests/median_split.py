"""A check that a device plan's tree is a median-split tree, for inputs on
which two builds may rightly differ: dims whose spreads tie in real
arithmetic, where the float64 sums' rounding order picks the split dim."""
import numpy as np


def _partitions(n):
    """Per depth of an ``n``-point tree, the ``(lo, hi)`` of every node
    (leaves persisting), in position order: the recursion ``split = (lo +
    hi) // 2``."""
    nodes = [(0, n - 1)]
    while any(hi > lo for lo, hi in nodes):
        yield nodes
        nodes = [c for lo, hi in nodes
                 for c in ([(lo, (lo + hi) // 2), ((lo + hi) // 2 + 1, hi)]
                           if hi > lo else [(lo, hi)])]


def median_split_violations(points, perm, rtol=1e-12):
    """The ``(lo, hi)`` of the nodes where the tree with leaf order
    ``perm[n:]`` (slot layout of ``device_tree_stats``) over ``points [n,
    d]`` is no median split: a node is one when some dim whose float64 sum
    of squared deviations over the node's points lies within ``rtol`` of
    the largest also has every point of the left half at or below every
    point of the right half.  Raises if the leaf order is no permutation."""
    x = np.asarray(points, dtype=np.float64)
    n = x.shape[0]
    order = np.asarray(perm)[n:]
    if sorted(order.tolist()) != list(range(n)):
        raise AssertionError("the leaf order is no permutation")
    x = x[order]
    padded = np.concatenate([x, x[:1]])
    bad = []
    for nodes in _partitions(n):
        lo = np.array([a for a, _ in nodes])
        hi = np.array([b for _, b in nodes])
        cnt = (hi - lo + 1)[:, None]
        mean = np.add.reduceat(x, lo, axis=0) / cnt
        dev = x - np.repeat(mean, cnt[:, 0], axis=0)
        ss = np.add.reduceat(dev * dev, lo, axis=0)
        split = hi > lo
        lo, hi, ss = lo[split], hi[split], ss[split]
        mid = (lo + hi) // 2
        cuts = np.stack([lo, mid + 1, hi + 1], axis=1).ravel()
        left = np.maximum.reduceat(padded, cuts, axis=0)[0::3]
        right = np.minimum.reduceat(padded, cuts, axis=0)[1::3]
        near = ss >= ss.max(axis=1, keepdims=True) * (1 - rtol)
        ok = (near & (left <= right)).any(axis=1)
        bad += [(int(a), int(b)) for a, b in zip(lo[~ok], hi[~ok])]
    return bad


def equal_spread_points(rng, n, d):
    """``n`` points in ``d`` dims whose every dim is another permutation of
    one column of rounded halves, a quarter of it one repeated value: the
    dims' spreads tie in real arithmetic at the root, and often below."""
    col = np.round(rng.normal(size=n) * 2) / 2
    col[n // 3:n // 3 + n // 4] = col[0]
    return np.stack([rng.permutation(col) for _ in range(d)], axis=1)
