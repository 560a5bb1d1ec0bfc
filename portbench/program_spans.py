"""The program's own spans, as the per-layer readers take them.

``kde_tpu_torch/utils/spans.py`` marks the port's layer boundaries: each
span is a record in the program's buffer (host nanoseconds, its parent,
its request) and, under the profiler, an annotation
``kde_tpu_torch.<name>`` on the window's thread of the trace, on the
kernels' clock.  This module reads both:

- :func:`records`: the program's records of the traced window, taken from
  its buffer once a run (kept on the readers' context);
- :func:`timeline`: the trace's program annotations, cut into pieces each
  charged to the innermost span open over it (``None``: no span, the
  harness's own loop), with each piece's idle time (the trace's idle
  intervals cut at every span edge, so the pieces' idle sums to the
  trace's idle exactly), the runtime launch calls made inside each span
  name, and the root spans by name.

A reader gives None where the program has no spans (a tree before them),
where records fell off the program's buffer, or where the spans it reads
are missing; it never gives a number from a partial buffer.
"""

from __future__ import annotations

import bisect
import importlib
from collections import Counter, defaultdict
from types import SimpleNamespace

PREFIX = "kde_tpu_torch."
# each span name's layer (PERF.md §3): the five parts of the idle split
LAYERS = {"plan": "plan", "streams": "sampling", "chains": "sampling",
          "loocv.bracket": "refit", "loocv.search": "refit",
          "product": "api", "gibbs": "api", "kde": "api", "sample": "api",
          None: "outside"}
# kernel launch calls of the CUDA runtime API (cudaLaunch*) and of its
# lower-level API (cuLaunch*), by name prefix
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch")


def records(ctx):
    """The program's span records of the run, or None."""
    if not hasattr(ctx, "program_records"):
        ctx.program_records = _take()
    return ctx.program_records


def _take():
    try:
        spans = importlib.import_module("kde_tpu_torch.utils.spans")
    except ImportError:
        return None
    lost = spans.dropped()
    recs = spans.records()
    return recs if recs and not lost else None


def host_ms(ctx, name: str, root: str):
    """Host milliseconds in spans ``name`` over the count of ``root``
    roots (spans with no parent) among the program's records."""
    recs = records(ctx)
    if recs is None:
        return None
    roots = sum(r["name"] == root and r["parent"] is None for r in recs)
    mine = [r["end_ns"] - r["start_ns"] for r in recs if r["name"] == name]
    if not roots or not mine:
        return None
    return 1e-6 * sum(mine) / roots


def timeline(ctx):
    """The traced window's program spans (see the module's doc), kept on
    the context: ``pieces`` ``[(start_us, end_us, name or None)]`` covering
    the window, ``idle_us`` by span name, ``launches`` by span name and
    ``roots`` by span name; None without the program's records or any
    program span in the trace."""
    if not hasattr(ctx, "program_timeline"):
        tr = ctx.trace
        spans = [(a, b, n[len(PREFIX):]) for a, b, n in tr._host
                 if n.startswith(PREFIX)]
        ctx.program_timeline = (_timeline(tr, spans)
                                if spans and records(ctx) is not None
                                else None)
    return ctx.program_timeline


def _timeline(tr, spans):
    pieces, roots, stack, t = [], Counter(), [], tr.t0
    for a, b, name in spans:             # sorted by (start, -end)
        if b <= tr.t0 or a >= tr.t1:
            continue
        a, b = max(a, tr.t0), min(b, tr.t1)
        while stack and stack[-1][0] <= a:
            end, inner = stack.pop()
            if end > t:
                pieces.append((t, end, inner))
                t = end
        if a > t:
            pieces.append((t, a, stack[-1][1] if stack else None))
            t = a
        if not stack:
            roots[name] += 1
        stack.append((min(b, stack[-1][0]) if stack else b, name))
    while stack:
        end, inner = stack.pop()
        if end > t:
            pieces.append((t, end, inner))
            t = end
    if tr.t1 > t:
        pieces.append((t, tr.t1, None))
    return SimpleNamespace(pieces=pieces, roots=roots,
                           idle_us=_idle(pieces, tr._gaps),
                           launches=_launches(pieces, tr._host))


def _idle(pieces, gaps):
    """Idle microseconds by span name: each gap cut at the pieces'
    edges."""
    out, k = defaultdict(float), 0
    for a, b in gaps:
        while k < len(pieces) and pieces[k][1] <= a:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < b:
            lo, hi = max(a, pieces[j][0]), min(b, pieces[j][1])
            if hi > lo:
                out[pieces[j][2]] += hi - lo
            j += 1
    return out


def _launches(pieces, host):
    """Runtime launch calls by the span name of the piece where each
    began."""
    starts = [p[0] for p in pieces]
    out = Counter()
    for a, _, name in host:
        if name.startswith(LAUNCH_CALLS):
            i = bisect.bisect_right(starts, a) - 1
            if 0 <= i and a < pieces[i][1]:
                out[pieces[i][2]] += 1
    return out


def idle_ms(ctx, layer: str, root: str = "product"):
    """Device-idle milliseconds charged to ``layer`` (:data:`LAYERS`), over
    the trace's ``root`` roots."""
    tl = timeline(ctx)
    if tl is None or not tl.roots[root]:
        return None
    us = sum(v for name, v in tl.idle_us.items()
             if LAYERS.get(name) == layer)
    return 1e-3 * us / tl.roots[root]


def launches(ctx, name: str, root: str = "product"):
    """Runtime launch calls made inside spans ``name`` over the trace's
    ``root`` roots."""
    tl = timeline(ctx)
    if tl is None or not tl.roots[root] or not any(
            p[2] == name for p in tl.pieces):
        return None
    return tl.launches[name] / tl.roots[root]
