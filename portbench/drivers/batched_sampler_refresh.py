"""Traffic kind ``batched_sampler_refresh``: the serving path of a
belief-propagation loop whose every iteration brings new messages.

Set-up makes ``groups`` groups of messages on the device, each ``sets``
density sets of ``densities`` beliefs of ``components`` points (one group
of mode centres a set, ``beliefs.make``) with their Silverman bandwidths,
and ``batched_sampler``'s two samplers over group 0: one drawing, and its
twin with ``add_entropy=False``, which makes one call in ``mean_every`` a
call without noise for the check.  The window runs as that kind's does
(``sample(key_i)`` back to back with a fresh key, the host waiting only
when ``outstanding`` calls are in flight), but before call ``i`` the host
makes new device-resident beliefs over the tensors of group ``i mod
groups`` and passes them to ``refresh`` on the sampler that call draws
from, so every call draws from a plan built for it (K8 on the card).  The
harness's span ``refresh`` (``harness_spans.py``) marks each ``refresh``.

Every call's first labels are counted into its group's row of a table made
in set-up, and the calls that two reservoirs drawn from the seed keep are
copied into buffers made there, with their group.  The check holds each
kept call to its own group, against the plain reference computed in
float64 from the benchmark's own inputs:

- ``mean_gap``: of ``checked_calls`` mean calls, the largest offset of a
  draw from the product of the kernels its labels name, in that product's
  standard deviations;
- ``draw_z``: each group's kept ordinary calls (``checked_draw_calls`` in
  all), set by set, against ``reference_chains`` chains of the reference's
  multiscale Gibbs product of the group (``reference/msgibbs.py``): the
  largest two-sample z of their first and second moments;
- ``label_z``: each group's counted first labels, as the first and second
  moments of the kernel centres they name, against those chains' first
  labels, the same way.

The control puts the reference in both samplers' place, its trees built
from the group's tensors at a refresh (``msgibbs.VARIANTS``); the variant
``stale`` is the float64 reference whose ``refresh`` keeps the trees of
the group it had before: a sampler that skips ``refresh()``.
"""

from __future__ import annotations

import time
from collections import deque
from types import SimpleNamespace

import torch

from portbench import beliefs, core, harness_spans, program
from portbench.reference import moments, msgibbs

serve = core.load_module(core.HERE / "drivers" / "batched_sampler.py")

WARM = 4
STALE = "stale"


def prepare(c: core.Cell):
    t, cfg = c.traffic, c.config
    grp, b, dn = int(t["groups"]), int(t["sets"]), int(t["densities"])
    n, n_out, d = int(t["components"]), int(t["n_out"]), len(cfg["dims"])
    g = beliefs.generator(c.seed, c.device)
    pts = beliefs.make(g, grp * b, dn, n, cfg, c.dtype, c.device)
    bw = beliefs.silverman(pts, cfg)
    kt = program.port()
    kd, km = int(t["checked_draw_calls"]), int(t["checked_calls"])
    dev = dict(device=c.device)
    state = SimpleNamespace(
        cell=c, pts=pts.reshape(grp, b, dn, n, d),
        bw=bw.reshape(grp, b, dn, d),
        counts=torch.zeros((grp, b * n), dtype=torch.int32, **dev),
        ones=torch.ones(b * n_out, dtype=torch.int32, **dev),
        base=torch.arange(b, **dev)[:, None] * n,
        draws=torch.empty((kd, b, d, n_out), dtype=c.dtype, **dev),
        draw_group=[-1] * kd,
        means=torch.empty((km, b, d, n_out), dtype=c.dtype, **dev),
        mean_labels=torch.empty((km, b, dn, n_out), dtype=torch.int64,
                                **dev),
        mean_group=[-1] * km)
    state.messages = lambda k: _messages(state, k)
    kw = dict(n_out=n_out, n_iter=int(cfg["n_iter"]))
    first = state.messages(0)
    state.samplers = {
        "draw": kt.BatchedProductSampler(first, add_entropy=True, **kw),
        "mean": kt.BatchedProductSampler(first, add_entropy=False, **kw)}
    for i in range(WARM):
        kind = ("draw", "mean")[i % 2]
        sampler = state.samplers[kind]
        sampler.refresh(state.messages(i % grp))
        out = sampler.sample(beliefs.derived(c.seed, -1 - i))
        _consume(state, kind, i % grp, out, None)
    state.counts.zero_()
    return state


def _messages(state, k):
    """New device-resident beliefs over group ``k``'s tensors: ``sets``
    lists of ``densities`` beliefs."""
    c = state.cell
    return [[program.density(state.pts[k, s, j], state.bw[k, s, j],
                             c.config)
             for j in range(state.pts.shape[2])]
            for s in range(state.pts.shape[1])]


def _consume(state, kind, group, out, slot):
    """Count a call's first labels into ``group``'s row and copy its draws,
    with the group, into ``slot`` of its kind's buffer (None: not kept)."""
    lab = out[1]
    state.counts[group].index_add_(0, (state.base + lab[:, 0]).reshape(-1),
                                   state.ones)
    if slot is None:
        return
    if kind == "draw":
        state.draws[slot].copy_(out[0])
        state.draw_group[slot] = group
    else:
        state.means[slot].copy_(out[0])
        state.mean_labels[slot].copy_(lab)
        state.mean_group[slot] = group


def _work(c, calls, refreshes):
    t = c.traffic
    npts = [int(t["components"])] * int(t["densities"])
    shape = dict(sets=int(t["sets"]), npts=npts, d=len(c.config["dims"]),
                 n_out=int(t["n_out"]), itemsize=c.dtype.itemsize)
    return {"k3_calls": [dict(shape, n_iter=int(c.config["n_iter"]))]
            * calls,
            "k8_plans": [shape] * refreshes}


def window(state, seconds: float, spans: core.Spans) -> core.Window:
    c, t = state.cell, state.cell.traffic
    every, depth = int(t["mean_every"]), int(t["outstanding"])
    groups = int(t["groups"])
    kept = {"draw": core.Reservoir(int(t["checked_draw_calls"]), c.seed),
            "mean": core.Reservoir(int(t["checked_calls"]), c.seed + 1)}
    win = core.Window()
    inflight = deque()
    per_call = int(t["sets"]) * int(t["n_out"])
    refreshes = 0
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        kind = "mean" if i % every == every - 1 else "draw"
        group = i % groups
        sampler = state.samplers[kind]
        win.attempted += 1
        try:
            sets = state.messages(group)
            h = time.perf_counter()
            with harness_spans.annotation("refresh"):
                sampler.refresh(sets)
            spans.add("refresh", time.perf_counter() - h)
            refreshes += 1
            out = sampler.sample(beliefs.derived(c.seed, i))
        except RuntimeError:
            win.failed += 1
            out = None
        if out is not None:
            _consume(state, kind, group, out, kept[kind].slot())
            win.samples += per_call
        inflight.append(serve._fence(c.device))
        if len(inflight) >= depth:
            ev = inflight.popleft()
            if ev is not None:
                ev.synchronize()
        i += 1
    core.sync(c.device)
    win.window_s = time.perf_counter() - t0
    win.kept = {k: r.filled() for k, r in kept.items()}
    win.work = _work(c, win.attempted - win.failed, refreshes)
    return win


class _Reference:
    """The plain reference's multiscale Gibbs product as variant ``kind``
    in a sampler's place: ``refresh`` takes a group's index, and ``sample``
    runs chains on the trees of the group it holds (with ``stale``, the
    group it held before the last refresh)."""

    def __init__(self, state, kind, entropy, trees_of):
        c = state.cell
        self.cell, self.entropy, self.trees_of = c, entropy, trees_of
        self.stale = kind == STALE
        n_iter = int(c.config["n_iter"])
        self.circ, self.n_iter = c.circ(), n_iter
        if not self.stale:
            _, self.circ, self.n_iter = msgibbs.variant(kind, self.circ,
                                                        n_iter)
        self.group = self.before = 0           # built over group 0

    def refresh(self, group):
        self.before, self.group = self.group, group

    def sample(self, key):
        c = self.cell
        trees = self.trees_of(self.before if self.stale else self.group)
        x, labels = msgibbs.run_chains(
            trees, self.circ, int(c.traffic["n_out"]), self.n_iter,
            beliefs.generator(key, c.device), self.entropy)
        return x.transpose(1, 2).to(c.dtype), labels.transpose(1, 2)


def control(state, seconds: float, kind: str) -> core.Window:
    """The reference as variant ``kind`` (``msgibbs.VARIANTS``, or
    ``stale``) in both samplers' place for ``seconds``: the same calls and
    refreshes, counted and kept the same way."""
    n_out = int(state.cell.traffic["n_out"])
    trees = {}

    def trees_of(group):
        if group not in trees:
            sets = _sets(state, group)
            trees[group] = (msgibbs.build_trees(sets, n_out)
                            if kind == STALE
                            else msgibbs.variant_trees(kind, sets, n_out))
        return trees[group]
    state.samplers = {"draw": _Reference(state, kind, True, trees_of),
                      "mean": _Reference(state, kind, False, trees_of)}
    state.messages = lambda group: group
    return window(state, seconds, core.Spans())


def release(state):
    state.samplers = None


def _belief(state, group, s, j, dtype=torch.float64):
    pts = state.pts[group, s, j].to(dtype)
    var = state.bw[group, s, j].to(dtype) ** 2
    lw = torch.full((pts.shape[0],), -float(torch.log(torch.tensor(
        float(pts.shape[0])))), dtype=dtype, device=pts.device)
    return pts, var, lw


def _sets(state, group):
    """Group ``group``'s density sets as the reference takes them."""
    return [[_belief(state, group, s, j) for j in range(state.pts.shape[2])]
            for s in range(state.pts.shape[1])]


def check(state, win: core.Window):
    c, t = state.cell, state.cell.traffic
    circ = c.circ()
    groups, b, n = int(t["groups"]), int(t["sets"]), int(t["components"])
    km, kd = win.kept["mean"], win.kept["draw"]
    gap = 0.0 if km else float("inf")
    for s in range(km):
        for k, bel in enumerate(_sets(state, state.mean_group[s])):
            r = msgibbs.labelled_residual(
                state.means[s, k].T.double(), state.mean_labels[s, k].T,
                bel, circ)
            gap = max(gap, float(r.abs().max()))
    draw_z = label_z = 0.0 if kd else float("inf")
    first = state.counts.reshape(groups, b, n)
    g = beliefs.generator(beliefs.derived(c.seed, -100), c.device)
    for group in range(groups if kd else 0):
        sets = _sets(state, group)
        ref, ref_lab = msgibbs.sample_sets(
            sets, circ, int(t["reference_chains"]), int(c.config["n_iter"]),
            g)
        slots = [s for s in range(kd) if state.draw_group[s] == group]
        for k, bel in enumerate(sets):
            if slots:
                got = state.draws[slots, k].transpose(1, 2).reshape(
                    -1, circ.shape[0])
                draw_z = max(draw_z, moments.moment_z(got, ref[k], circ))
            ref_first = torch.bincount(ref_lab[k, :, 0], minlength=n)
            label_z = max(label_z, moments.moment_z(
                bel[0][0], bel[0][0], circ, wa=first[group, k],
                wb=ref_first))
    return [core.checked("mean_gap", gap, c.limits),
            core.checked("draw_z", draw_z, c.limits),
            core.checked("label_z", label_z, c.limits)], {}
