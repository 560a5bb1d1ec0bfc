"""The harness's own spans around calls into the program, in the trace.

A driver wraps a call in :func:`annotation`: while the profiler runs, the
annotation ``portbench.<name>`` lies on the window's thread of the trace,
on the kernels' clock; otherwise it costs one flag test.  The readers take
from the trace, per annotation in the window, the runtime's kernel launch
calls that began inside it and the device idle time inside it (the trace's
idle intervals cut at its edges).  A reader gives None where the window
holds no such annotation."""

from __future__ import annotations

import bisect
import contextlib

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

from portbench.program_spans import LAUNCH_CALLS

PREFIX = "portbench."
_NULL = contextlib.nullcontext()


def annotation(name: str):
    """``portbench.<name>`` in the trace while the profiler runs."""
    if getattr(_profiler, "_is_profiler_enabled", False):
        return record_function(PREFIX + name)
    return _NULL


def intervals(trace, name: str):
    """``[(start_us, end_us)]`` of the annotations ``name`` inside the
    window, in order (one thread's annotations of one name do not
    overlap)."""
    full = PREFIX + name
    return [(max(a, trace.t0), min(b, trace.t1)) for a, b, n in trace._host
            if n == full and b > trace.t0 and a < trace.t1]


def _inside(spans, t):
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t < spans[i][1]


def launches(trace, name: str):
    """Runtime launch calls begun inside annotations ``name``, a span."""
    spans = intervals(trace, name)
    if not spans:
        return None
    inside = sum(_inside(spans, a) for a, _, n in trace._host
                 if n.startswith(LAUNCH_CALLS))
    return inside / len(spans)


def idle_ms(trace, name: str):
    """Device-idle milliseconds inside annotations ``name``, a span."""
    spans = intervals(trace, name)
    if not spans:
        return None
    us, k = 0.0, 0
    for a, b in trace._gaps:                 # in order, disjoint
        while k < len(spans) and spans[k][1] <= a:
            k += 1
        j = k
        while j < len(spans) and spans[j][0] < b:
            us += max(0.0, min(b, spans[j][1]) - max(a, spans[j][0]))
            j += 1
    return 1e-3 * us / len(spans)
