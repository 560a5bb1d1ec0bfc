"""Traffic kind ``batched_sampler``: the serving path of belief propagation.

Set-up makes ``sets`` density sets of ``densities`` beliefs of
``components`` points on the device, their Silverman bandwidths, and one
``BatchedProductSampler`` over them (its plan built there), plus a second
sampler over the same sets with ``add_entropy=False``.  The window calls
``sample(key_i)`` back to back with a fresh key each call, the host waiting
only when ``outstanding`` calls are in flight, as a BP loop consumes one
iteration's draws while the next runs.  Every ``mean_every``-th call draws
from the second sampler: its points are the product means of their labels,
which the check reads exactly.  That twin is the check's, not a user's: it
makes one call in ``mean_every`` a call without noise.

Every call's first labels are counted into a table made in set-up, and the
draws of the calls that two reservoirs drawn from the seed keep are copied
into buffers made there, so the window allocates nothing for the check.
The check compares, against the plain reference computed in float64 from
the benchmark's own inputs:

- ``mean_gap``: of ``checked_calls`` mean calls, the largest offset of a
  draw from the product of the kernels its labels name, in that product's
  standard deviations (the points' arithmetic);
- ``draw_z``: the draws of ``checked_draw_calls`` ordinary calls, set by
  set, against as many draws of the reference's multiscale Gibbs product
  (``reference/msgibbs.py``): the largest two-sample z of their first and
  second moments (the whole chain: both labels, the noise);
- ``label_z``: the first density's label of every call, as the first and
  second moments of the kernel centres it names, against the reference's
  chains' first labels, the same way.
"""

from __future__ import annotations

import time
from collections import deque
from types import SimpleNamespace

import torch

from portbench import beliefs, core, program
from portbench.reference import moments, msgibbs

WARM = 4


def prepare(c: core.Cell):
    t, cfg = c.traffic, c.config
    if int(t["densities"]) != 2:
        raise ValueError("batched_sampler checks sets of two densities")
    g = beliefs.generator(c.seed, c.device)
    b, dn, n = int(t["sets"]), int(t["densities"]), int(t["components"])
    n_out, d = int(t["n_out"]), len(cfg["dims"])
    pts = beliefs.make(g, b, dn, n, cfg, c.dtype, c.device)
    bw = beliefs.silverman(pts, cfg)
    sets = [[program.density(pts[i, j], bw[i, j], cfg) for j in range(dn)]
            for i in range(b)]
    kt = program.port()
    kw = dict(n_out=n_out, n_iter=int(cfg["n_iter"]))
    dev = dict(device=c.device)
    kd, km = int(t["checked_draw_calls"]), int(t["checked_calls"])
    state = SimpleNamespace(
        cell=c, pts=pts, bw=bw,
        samplers={"draw": kt.BatchedProductSampler(sets, add_entropy=True,
                                                   **kw),
                  "mean": kt.BatchedProductSampler(sets, add_entropy=False,
                                                   **kw)},
        counts=torch.zeros(b * n, dtype=torch.int32, **dev),
        ones=torch.ones(b * n_out, dtype=torch.int32, **dev),
        base=torch.arange(b, **dev)[:, None] * n,
        draws=torch.empty((kd, b, d, n_out), dtype=c.dtype, **dev),
        means=torch.empty((km, b, d, n_out), dtype=c.dtype, **dev),
        mean_labels=torch.empty((km, b, dn, n_out), dtype=torch.int64,
                                **dev))
    for i in range(WARM):
        kind = ("draw", "mean")[i % 2]
        out = state.samplers[kind].sample(beliefs.derived(c.seed, -1 - i))
        _consume(state, kind, out, 0)
    state.counts.zero_()
    return state


def _consume(state, kind, out, slot):
    """Count a call's first labels and copy its draws into ``slot`` of its
    kind's buffer (None: not kept)."""
    lab = out[1]
    state.counts.index_add_(0, (state.base + lab[:, 0]).reshape(-1),
                            state.ones)
    if slot is None:
        return
    if kind == "draw":
        state.draws[slot].copy_(out[0])
    else:
        state.means[slot].copy_(out[0])
        state.mean_labels[slot].copy_(lab)


def _fence(device):
    if device == "cuda":
        ev = torch.cuda.Event()
        ev.record()
        return ev
    return None


def _work(c, calls):
    t = c.traffic
    return {"k3_calls": [dict(sets=int(t["sets"]),
                              npts=[int(t["components"])] * 2,
                              d=len(c.config["dims"]), n_out=int(t["n_out"]),
                              n_iter=int(c.config["n_iter"]),
                              itemsize=c.dtype.itemsize)] * calls}


def window(state, seconds: float, spans: core.Spans) -> core.Window:
    c, t = state.cell, state.cell.traffic
    every, depth = int(t["mean_every"]), int(t["outstanding"])
    kept = {"draw": core.Reservoir(int(t["checked_draw_calls"]), c.seed),
            "mean": core.Reservoir(int(t["checked_calls"]), c.seed + 1)}
    win = core.Window()
    inflight = deque()
    per_call = int(t["sets"]) * int(t["n_out"])
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        kind = "mean" if i % every == every - 1 else "draw"
        win.attempted += 1
        h = time.perf_counter()
        try:
            out = state.samplers[kind].sample(beliefs.derived(c.seed, i))
        except RuntimeError:
            win.failed += 1
            out = None
        spans.add("call_host", time.perf_counter() - h)
        if out is not None:
            _consume(state, kind, out, kept[kind].slot())
            win.samples += per_call
        inflight.append(_fence(c.device))
        if len(inflight) >= depth:
            ev = inflight.popleft()
            if ev is not None:
                ev.synchronize()
        i += 1
    core.sync(c.device)
    win.window_s = time.perf_counter() - t0
    win.kept = {k: r.filled() for k, r in kept.items()}
    win.work = _work(c, win.attempted - win.failed)
    return win


class _Reference:
    """The plain reference's multiscale Gibbs product as variant ``kind``
    (``msgibbs.VARIANTS``), set by set, in a sampler's place."""

    def __init__(self, state, kind, entropy, trees):
        c = state.cell
        self.cell, self.entropy, self.trees = c, entropy, trees
        _, self.circ, self.n_iter = msgibbs.variant(
            kind, c.circ(), int(c.config["n_iter"]))

    def sample(self, key):
        c = self.cell
        x, labels = msgibbs.run_chains(
            self.trees, self.circ, int(c.traffic["n_out"]), self.n_iter,
            beliefs.generator(key, c.device), self.entropy)
        return x.transpose(1, 2).to(c.dtype), labels.transpose(1, 2)


def control(state, seconds: float, kind: str) -> core.Window:
    """The reference as variant ``kind`` in both samplers' place for
    ``seconds``: the same calls, counted and kept the same way."""
    sets = [[_belief(state, b, j) for j in range(2)]
            for b in range(state.pts.shape[0])]
    trees = msgibbs.variant_trees(kind, sets, int(state.cell.traffic["n_out"]))
    state.samplers = {"draw": _Reference(state, kind, True, trees),
                      "mean": _Reference(state, kind, False, trees)}
    return window(state, seconds, core.Spans())


def release(state):
    state.samplers = None


def _belief(state, b, j, dtype=torch.float64):
    pts = state.pts[b, j].to(dtype)
    var = state.bw[b, j].to(dtype) ** 2
    lw = torch.full((pts.shape[0],), -float(torch.log(torch.tensor(
        float(pts.shape[0])))), dtype=dtype, device=pts.device)
    return pts, var, lw


def check(state, win: core.Window):
    c, t = state.cell, state.cell.traffic
    circ = c.circ()
    b, n, n_out = int(t["sets"]), int(t["components"]), int(t["n_out"])
    sets = [[_belief(state, k, j) for j in range(2)] for k in range(b)]
    km, kd = win.kept["mean"], win.kept["draw"]
    gap = 0.0 if km else float("inf")
    for s in range(km):
        for k, bel in enumerate(sets):
            r = msgibbs.labelled_residual(
                state.means[s, k].T.double(), state.mean_labels[s, k].T,
                bel, circ)
            gap = max(gap, float(r.abs().max()))
    draw_z = label_z = 0.0 if kd else float("inf")
    first = state.counts.reshape(b, n)
    if kd:
        ref, ref_lab = msgibbs.sample_sets(
            sets, circ, kd * n_out, int(c.config["n_iter"]),
            beliefs.generator(beliefs.derived(c.seed, -100), c.device))
    for k, bel in enumerate(sets if kd else []):
        got = state.draws[:kd, k].transpose(1, 2).reshape(-1, circ.shape[0])
        draw_z = max(draw_z, moments.moment_z(got, ref[k], circ))
        ref_first = torch.bincount(ref_lab[k, :, 0], minlength=n)
        label_z = max(label_z, moments.moment_z(
            bel[0][0], bel[0][0], circ, wa=first[k], wb=ref_first))
    return [core.checked("mean_gap", gap, c.limits),
            core.checked("draw_z", draw_z, c.limits),
            core.checked("label_z", label_z, c.limits)], {}
