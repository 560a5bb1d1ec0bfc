"""Traffic kind ``product``: the ``*`` of a chained BP update.

Set-up makes ``inputs`` products' worth of beliefs (``densities`` beliefs of
``components`` points each, their Silverman bandwidths) on the device, and
two more for the warm-up.  One client runs a closed loop: each request
builds fresh device-resident beliefs from the next tensors (after
``inputs`` requests the tensors repeat, as new objects, so the program's
plan cache, keyed by object, never hits), calls ``product(beliefs,
key=k_i)`` and synchronises.  The latency runs from the request's start to
that synchronise.

The check reads ``checked_requests`` requests drawn from the seed:

- ``bw_rel``: each dim's refit bandwidth (K4) against the reference's
  LOOCV search, in float64, over the points the program returned,
  relative;
- ``dup_share``: the share of draws equal to another draw (continuous
  draws in float32 never are; chains left out and filled with others'
  draws, or draws rounded to a coarser type, are);
- ``draw_z``: the draws of the first ``moment_requests`` of them (the
  device plan's hierarchy, K3's chains with their hooks) against as many
  draws of the reference's multiscale Gibbs product of all ``densities``
  beliefs of the request (``reference/msgibbs.py``): the largest
  two-sample z of their first and second moments, circular moments on a
  circular dim.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from portbench import beliefs, core, program
from portbench.reference import loocv, moments, msgibbs

WARM = 2


def prepare(c: core.Cell):
    t, cfg = c.traffic, c.config
    g = beliefs.generator(c.seed, c.device)
    m, dn, n = int(t["inputs"]), int(t["densities"]), int(t["components"])
    pts = beliefs.make(g, m + WARM, dn, n, cfg, c.dtype, c.device)
    bw = beliefs.silverman(pts, cfg)
    state = SimpleNamespace(cell=c, pts=pts, bw=bw, kt=program.port())
    for i in range(WARM):
        _request(state, m + i, beliefs.derived(c.seed, -1 - i))
    return state


def _request(state, k, key):
    c = state.cell
    dens = [program.density(state.pts[k, j], state.bw[k, j], c.config)
            for j in range(state.pts.shape[1])]
    return state.kt.product(dens, key=key)


def window(state, seconds: float, spans: core.Spans) -> core.Window:
    c, t = state.cell, state.cell.traffic
    m = int(t["inputs"])
    kept = core.Reservoir(int(t["checked_requests"]), c.seed)
    win = core.Window()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        k, key = i % m, beliefs.derived(c.seed, i)
        win.attempted += 1
        s = time.perf_counter()
        try:
            out = _request(state, k, key)
            core.sync(c.device)
        except RuntimeError:
            win.failed += 1
            out = None
        win.latency_ms.append(1e3 * (time.perf_counter() - s))
        if out is not None:
            kept.offer(i, (k, out.points, torch.sqrt(out.bw[0])))
            win.samples += out.npts
        i += 1
    win.window_s = time.perf_counter() - t0
    win.kept = {"requests": kept.values()}
    win.work = {"k3_calls": [dict(sets=1, npts=[int(t["components"])]
                                  * int(t["densities"]),
                                  d=len(c.config["dims"]),
                                  n_out=int(t["components"]),
                                  n_iter=int(c.config["n_iter"]),
                                  itemsize=state.pts.element_size())]
                * (win.attempted - win.failed)}
    return win


def control(state, seconds: float, kind: str) -> core.Window:
    """The plain reference as variant ``kind`` (``msgibbs.VARIANTS``) in the
    program's place, for as many requests as a run checks: its multiscale
    Gibbs draws and their LOOCV refit, in the variant's dtype."""
    c, t = state.cell, state.cell.traffic
    g = beliefs.generator(c.seed + 1, c.device)
    dtype = msgibbs.VARIANTS[kind].get("dtype", torch.float64)
    win = core.Window(window_s=1.0)
    outs = []
    dn = state.pts.shape[1]
    for i in range(int(t["checked_requests"])):
        x, _ = msgibbs.sample_variant(
            kind, [[_belief(state, i, j) for j in range(dn)]], c.circ(),
            int(t["components"]), int(c.config["n_iter"]), g)
        x = x[0]
        bw, _ = loocv.ksize(x, float(c.config["loocv_tol"]), dtype)
        outs.append((i, (i, x.float(), torch.tensor(bw, device=x.device))))
        win.attempted += 1
    win.kept = {"requests": outs}
    return win


def release(state):
    state.kt = None


def _belief(state, k, j, dtype=torch.float64):
    pts = state.pts[k, j].to(dtype)
    var = state.bw[k, j].to(dtype) ** 2
    lw = torch.full((pts.shape[0],), -float(torch.log(torch.tensor(
        float(pts.shape[0])))), dtype=dtype, device=pts.device)
    return pts, var, lw


def check(state, win: core.Window):
    c, t = state.cell, state.cell.traffic
    tol = float(c.config["loocv_tol"])
    circ = c.circ()
    g = beliefs.generator(beliefs.derived(c.seed, -100), c.device)
    kept = win.kept["requests"]
    dn = state.pts.shape[1]
    worst = dict(bw_rel=0.0, dup_share=0.0,
                 draw_z=0.0 if kept else float("inf"))
    for r, (_, (k, pts, bw)) in enumerate(kept):
        ref, _ = loocv.ksize(pts, tol)
        ref = torch.tensor(ref)
        rel = ((bw.double().cpu() - ref).abs() / ref).max()
        worst["bw_rel"] = max(worst["bw_rel"], float(rel))
        dup = 1.0 - torch.unique(pts, dim=0).shape[0] / pts.shape[0]
        worst["dup_share"] = max(worst["dup_share"], dup)
        if r < int(t["moment_requests"]):
            x, _ = msgibbs.sample([_belief(state, k, j) for j in range(dn)],
                                  circ, pts.shape[0], int(c.config["n_iter"]),
                                  g)
            worst["draw_z"] = max(worst["draw_z"],
                                  moments.moment_z(pts, x, circ))
    return [core.checked(k, v, c.limits) for k, v in worst.items()], {}
