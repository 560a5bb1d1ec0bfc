"""Traffic kind ``fit``: a belief fitted from a large particle set.

Set-up makes ``inputs`` point sets of ``components`` points on the device
(one belief each) and one more for the warm-up.  One client runs a closed
loop: each request copies the next set in turn into a fresh tensor (before
its clock starts), calls ``kde(points)`` with ``bw=None``, which selects
the bandwidths by LOOCV, and synchronises.

The check compares every fit of the window: ``bw_rel``, each dim's
bandwidth against the reference's LOOCV search over the same points,
relative.  The reference's probe counts give the per-layer bound.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from portbench import beliefs, core, program
from portbench.reference import loocv


def prepare(c: core.Cell):
    t = c.traffic
    g = beliefs.generator(c.seed, c.device)
    m, n = int(t["inputs"]), int(t["components"])
    pts = beliefs.make(g, m + 1, 1, n, c.config, c.dtype, c.device)[:, 0]
    state = SimpleNamespace(cell=c, pts=pts, kt=program.port())
    state.kt.kde(pts[m].T.contiguous())
    state.kt.kde(pts[m].T.contiguous())
    return state


def window(state, seconds: float, spans: core.Spans) -> core.Window:
    c, m = state.cell, int(state.cell.traffic["inputs"])
    win = core.Window()
    fits = []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        k = i % m
        x = state.pts[k].T.contiguous()
        win.attempted += 1
        s = time.perf_counter()
        try:
            p = state.kt.kde(x)
            core.sync(c.device)
        except RuntimeError:
            win.failed += 1
            p = None
        win.latency_ms.append(1e3 * (time.perf_counter() - s))
        if p is not None:
            fits.append((k, torch.sqrt(p.bw[0])))
            win.samples += p.npts
        i += 1
    win.window_s = time.perf_counter() - t0
    win.kept = {"fits": fits}
    win.work = {"k4_fits": [k for k, _ in fits],
                "n": int(state.pts.shape[1]),
                "itemsize": state.pts.element_size()}
    return win


def control(state, seconds: float, kind: str) -> core.Window:
    """The reference's LOOCV search in bfloat16 in the program's place, for
    each point set (the only variant a fit has: ``kind`` is
    ``bfloat16``)."""
    if kind != "bfloat16":
        raise ValueError(f"a fit's control is bfloat16, not {kind!r}")
    c = state.cell
    win = core.Window(window_s=1.0)
    fits = []
    for k in range(int(c.traffic["inputs"])):
        bw, _ = loocv.ksize(state.pts[k], float(c.config["loocv_tol"]),
                            torch.bfloat16)
        fits.append((k, torch.tensor(bw)))
        win.attempted += 1
    win.kept = {"fits": fits}
    return win


def release(state):
    state.kt = None


def check(state, win: core.Window):
    c = state.cell
    tol = float(c.config["loocv_tol"])
    ref, probes = {}, {}
    for k in sorted({k for k, _ in win.kept["fits"]}):
        ref[k], probes[k] = loocv.ksize(state.pts[k], tol)
    worst = 0.0
    for k, bw in win.kept["fits"]:
        want = torch.tensor(ref[k])
        worst = max(worst, float(((bw.double().cpu() - want).abs()
                                  / want).max()))
    return [core.checked("bw_rel", worst, c.limits)], {"probes": probes}
