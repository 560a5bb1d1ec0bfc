"""The plain reference of the multiscale Gibbs product, in PyTorch.

KernelDensityEstimate.jl's ``prodAppxMSGibbsS`` (src/MSGibbs01.jl:645-703)
draws from an approximation of the product of beliefs.  Each belief's
points are clustered by a median-split tree (src/BallTree01.jl:342-411: a
slice of ``s >= 2`` points, sorted along the dim in which its points spread
most, splits into its first ``ceil(s / 2)`` and its last ``floor(s / 2)``),
and every node is the moment-matched Gaussian of its slice, weighted by the
slice's weight (calcStatsDensity!, src/BallTreeDensity01.jl:141-187).  A
chain starts at every tree's root and walks down
``floor(log2(max(n_out, n_1, ...))) + 1`` levels, a leaf persisting
(levelDown!, src/MSGibbs01.jl:500-523).  At each level it draws a point
from the product of its current picks and picks every belief's node at the
level given that point (:594-600), then runs ``n_iter`` sweeps in which
each belief's node is drawn given the product of the other beliefs' picks
(:604-608); after the last level it draws from the product of its leaves
(:612-625).  A pick whose candidates together weigh under 1e-99 is uniform
(:311-315).

A belief is ``(mu [n, d], var [d], logw [n])``: kernel centres, the
shared kernel variance of each dim and the log weights.  ``circ [d]`` flags the circular dims, on which differences and sums wrap to
[-pi, pi] by rounding and a product's mean steps from its pick of most
information (the hooks of src/MSGibbs01.jl:672-675).  The tree's statistics
are arithmetic on every dim, as the algorithm's are.  The chains run in the
dtype asked for, in blocks of chains, and draw their picks by the
Gumbel-max rule.  It imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from ..bounds.hierarchy import n_levels

LOG_DEAD = math.log(1e-99)
# elements of one [chains, candidates, dims] block
BLOCK = 1 << 25
TWO_PI = 2.0 * math.pi


def _wrap(t, circ):
    """``t [..., d]`` wrapped to [-pi, pi] by rounding on the dims that
    ``circ [d]`` flags."""
    return torch.where(circ, t - TWO_PI * torch.round(t / TWO_PI), t)


def _segments(sizes):
    return torch.repeat_interleave(
        torch.arange(sizes.numel(), device=sizes.device), sizes)


def _stats(x, v, w, order, sizes):
    """The nodes of the slices ``sizes`` of ``order``: mean, variance and
    log weight of each slice's mixture, and a leaf's point (-1 for a wider
    node)."""
    seg = _segments(sizes)
    s, d = sizes.numel(), x.shape[1]
    xs, vs, ws = x[order], v[order], w[order]
    tot = torch.zeros(s, dtype=x.dtype, device=x.device).index_add_(0, seg,
                                                                     ws)
    mean = torch.zeros(s, d, dtype=x.dtype, device=x.device).index_add_(
        0, seg, ws[:, None] * xs) / tot[:, None]
    dev = xs - mean[seg]
    var = torch.zeros(s, d, dtype=x.dtype, device=x.device).index_add_(
        0, seg, ws[:, None] * (vs + dev * dev)) / tot[:, None]
    start = torch.cumsum(sizes, 0) - sizes
    leaf = torch.where(sizes == 1, order[start], -1)
    return mean, var, torch.log(tot), leaf


def tree_levels(mu, var, logw, levels: int):
    """Levels 0 to ``levels`` of the belief's tree, each ``(mean [w, d],
    var [w, d], logw [w], leaf [w])``: its nodes in slice order, ``leaf``
    a leaf's point index (-1 for a wider node).  In float64."""
    n, d = mu.shape
    x = mu.double()
    v = var.double().expand(n, d)
    w = torch.exp(logw.double())
    order = torch.arange(n, device=mu.device)
    sizes = torch.tensor([n], device=mu.device)
    out = [_stats(x, v, w, order, sizes)]
    for _ in range(levels):
        split = sizes >= 2
        if not bool(split.any()):
            out.append(out[-1])
            continue
        seg = _segments(sizes)
        xs = x[order]
        count = sizes.double()[:, None]
        centre = torch.zeros(sizes.numel(), d, dtype=x.dtype,
                             device=x.device).index_add_(0, seg, xs) / count
        dev = xs - centre[seg]
        spread = torch.zeros_like(centre).index_add_(0, seg, dev * dev)
        dim = spread.argmax(1)
        key = xs.gather(1, dim[seg][:, None])[:, 0]
        by_key = torch.sort(key, stable=True).indices
        by_seg = torch.sort(seg[by_key], stable=True).indices
        order = order[by_key[by_seg]]
        halves = torch.stack([torch.where(split, (sizes + 1) // 2, sizes),
                              torch.where(split, sizes // 2, 0)], 1)
        sizes = halves.reshape(-1)
        sizes = sizes[sizes > 0]
        out.append(_stats(x, v, w, order, sizes))
    return out


def product(mu, var, circ, skip=None):
    """The product of the picks ``mu``/``var [..., k, d]`` (leaving out pick
    ``skip``): ``(mean, var) [..., d]``; on a circular dim the mean steps
    from the pick of most information, the first of equals."""
    lam = 1.0 / var
    if skip is not None:
        drop = torch.arange(var.shape[-2], device=var.device) == skip
        lam = torch.where(drop[:, None], 0.0, lam)
    cov = 1.0 / lam.sum(-2)
    anchor = lam.argmax(-2, keepdim=True)
    ref = mu.gather(-2, anchor)
    step = cov * (lam * _wrap(mu - ref, circ)).sum(-2)
    return _wrap(ref[..., 0, :] + step, circ), cov


def labelled_residual(x, labels, beliefs, circ):
    """``[n, d]``: each draw of ``x [n, d]`` offset from the product of the
    kernels that its ``labels [n, dn]`` name, in that product's standard
    deviations."""
    circ = torch.as_tensor(circ, device=x.device)
    mus = torch.stack([b[0][labels[:, k]] for k, b in enumerate(beliefs)], 1)
    vs = torch.stack([b[1].expand_as(b[0])[labels[:, k]]
                      for k, b in enumerate(beliefs)], 1)
    mu, var = product(mus, vs, circ)
    return _wrap(x - mu, circ) / torch.sqrt(var)


def _uniform(shape, dtype, g, device):
    high = torch.float64 if dtype == torch.float64 else torch.float32
    eps = 1e-12 if high == torch.float64 else 1e-7
    return torch.rand(shape, generator=g, dtype=high, device=device
                      ).clamp(eps, 1.0 - eps)


def _normal(shape, dtype, g, device):
    high = torch.float64 if dtype == torch.float64 else torch.float32
    return torch.randn(shape, generator=g, dtype=high, device=device
                       ).to(dtype)


def logits(level, at, cov, circ):
    """``[B, c, w]``: the log weight of each node of ``level`` (``mean`` and
    ``var [B, w, d]``, ``logw [B, w]``) times the Gaussian of the node's
    mean and variance (plus ``cov [B, c, d]``, if given) at ``at [B, c,
    d]``, up to a constant; a row whose total falls under 1e-99 is
    uniform."""
    mean, var, logw = level[:3]
    s = var[:, None] if cov is None else var[:, None] + cov[:, :, None]
    t = _wrap(mean[:, None] - at[:, :, None], circ)
    out = logw[:, None] - 0.5 * (t * t / s + torch.log(s)).sum(-1)
    dead = torch.logsumexp(out, -1) < LOG_DEAD
    return torch.where(dead[..., None], 0.0, out)


def _choose(lg, g):
    u = _uniform(lg.shape, lg.dtype, g, lg.device)
    return torch.argmax(lg - torch.log(-torch.log(u)).to(lg.dtype), -1)


def _chains(trees, circ, c, n_iter, g, entropy):
    dn, d = len(trees), circ.shape[0]
    root = trees[0][0][0]
    b, dt, dev = root.shape[0], root.dtype, root.device
    mu = torch.stack([t[0][0][:, 0] for t in trees], 1)[:, None].expand(
        b, c, dn, d).clone()
    var = torch.stack([t[0][1][:, 0] for t in trees], 1)[:, None].expand(
        b, c, dn, d).clone()
    picks = torch.zeros(b, c, dn, dtype=torch.int64, device=dev)

    def pick(j, level, at, cov):
        z = _choose(logits(level, at, cov, circ), g)
        at_z = z[..., None].expand(b, c, d)
        mu[:, :, j] = level[0].gather(1, at_z)
        var[:, :, j] = level[1].gather(1, at_z)
        picks[:, :, j] = z

    def draw(noise):
        mean, cov = product(mu, var, circ)
        if not noise:
            return mean
        return _wrap(mean + torch.sqrt(cov) * _normal(mean.shape, dt, g, dev),
                     circ)

    levels = len(trees[0]) - 1
    for lv in range(1, levels + 1):
        x = draw(True)
        for j in range(dn):
            pick(j, trees[j][lv], x, None)
        for _ in range(n_iter):
            for j in range(dn):
                at, cov = product(mu, var, circ, skip=j)
                pick(j, trees[j][lv], at, cov)
    labels = torch.stack([trees[j][levels][3].gather(1, picks[:, :, j])
                          for j in range(dn)], -1)
    return draw(entropy), labels


def build_trees(sets, n_out: int, dtype=torch.float64):
    """The trees of ``sets`` (``B`` lists of ``dn`` beliefs; a belief's
    component count the same in every set) for chains of ``n_out`` draws:
    for each belief position, each level's ``(mean, var [B, w, d], logw,
    leaf [B, w])``, in ``dtype``."""
    levels = n_levels(n_out, [b[0].shape[0] for b in sets[0]])
    per_set = [[tree_levels(*b, levels) for b in beliefs] for beliefs in sets]
    return [[tuple(torch.stack([s[j][lv][i] for s in per_set]).to(
        dtype if i < 3 else torch.int64) for i in range(4))
        for lv in range(levels + 1)] for j in range(len(sets[0]))]


def run_chains(trees, circ, n_out: int, n_iter: int, g: torch.Generator,
               entropy: bool = True):
    """``n_out`` chains of every set of ``trees`` (:func:`build_trees`),
    their randomness from ``g``: ``(x [B, n_out, d], labels [B, n_out,
    dn])``, each chain's draw and the points of its leaves.  With
    ``entropy`` False a draw is its leaves' product mean."""
    root = trees[0][0][0]
    circ = torch.as_tensor(circ, device=root.device)
    width = max(lv[0].shape[1] for t in trees for lv in t)
    block = max(1, min(n_out, BLOCK // (root.shape[0] * width
                                        * circ.shape[0])))
    xs, labels = [], []
    for c0 in range(0, n_out, block):
        x, lab = _chains(trees, circ, min(block, n_out - c0), n_iter, g,
                         entropy)
        xs.append(x)
        labels.append(lab)
    return torch.cat(xs, 1), torch.cat(labels, 1)


def sample_sets(sets, circ, n_out: int, n_iter: int, g: torch.Generator,
                entropy: bool = True, dtype=torch.float64):
    """:func:`run_chains` over the trees of ``sets`` in ``dtype``."""
    return run_chains(build_trees(sets, n_out, dtype), circ, n_out, n_iter,
                      g, entropy)


def sample(beliefs, circ, n_out: int, n_iter: int, g: torch.Generator,
           entropy: bool = True, dtype=torch.float64):
    """:func:`sample_sets` of the one set ``beliefs``: ``(x [n_out, d],
    labels [n_out, dn])``."""
    x, labels = sample_sets([beliefs], circ, n_out, n_iter, g, entropy,
                            dtype)
    return x[0], labels[0]


# The reference in the program's place: the control, one precision below
# the configurations' float32, and faults planted in its chains: the
# circular hooks dropped; one sweep a level where the configuration states
# ``n_iter``; the chains run on a set's last belief alone, as if the others
# were left out.
VARIANTS = {"bfloat16": dict(dtype=torch.bfloat16),
            "no_hooks": dict(hooks=False),
            "one_sweep": dict(n_iter=1),
            "last_alone": dict(alone=True)}


def variant(kind: str, circ, n_iter: int):
    """``(dtype, circ, n_iter)`` as the variant ``kind`` of
    :data:`VARIANTS` has them."""
    v = VARIANTS[kind]
    circ = torch.as_tensor(circ)
    if not v.get("hooks", True):
        circ = torch.zeros_like(circ)
    return v.get("dtype", torch.float64), circ, v.get("n_iter", n_iter)


def variant_trees(kind: str, sets, n_out: int):
    """:func:`build_trees` of ``sets`` with every belief cast to the dtype
    of the variant ``kind`` first."""
    dtype = variant(kind, [], 0)[0]
    if VARIANTS[kind].get("alone"):
        sets = [beliefs[-1:] for beliefs in sets]
    low = [[tuple(t.to(dtype) for t in b) for b in beliefs]
           for beliefs in sets]
    return build_trees(low, n_out, dtype)


def sample_variant(kind: str, sets, circ, n_out: int, n_iter: int,
                   g: torch.Generator, entropy: bool = True):
    """:func:`sample_sets` as the variant ``kind`` of :data:`VARIANTS` runs
    it, on the beliefs of ``sets`` cast to its dtype."""
    _, circ, n_iter = variant(kind, circ, n_iter)
    return run_chains(variant_trees(kind, sets, n_out), circ, n_out, n_iter,
                      g, entropy)
