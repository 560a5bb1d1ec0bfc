"""Spans at the port's layer boundaries: which layer the host was in, when.

A span marks one pass through a layer boundary (PERF.md's layers):

    with span("plan", impl="device") as attrs:
        ...

It is on while ``torch.profiler`` is active or inside :func:`recording`,
and off otherwise.  Off, ``span`` costs one flag test and returns a shared
null context whose ``as`` target is None: no ``record_function``, no clock
read, no counter read.  On, a span appends a record to an in-memory buffer
when it closes (``name``, ``start_ns`` / ``end_ns`` from
``time.perf_counter_ns``, its ``id``, its ``parent``'s id, ``request``: the
id of its root span, ``attrs``, and ``error`` when an exception left it),
and while the profiler is active it also enters
``torch.profiler.record_function("kde_tpu_torch." + name)``, so the span
lies in the profiler's trace on the host thread, on the kernels' clock.
``attrs`` is the record's dict: a caller may add to it while the span is
open.  On close, ``attrs["launches"]`` holds the change in each of the
port's launch counters (:data:`COUNTERS`) that moved while it was open.

The buffer keeps the last :data:`MAXLEN` records; :func:`records` returns
and clears them, :func:`dropped` counts those that fell off since.
``utils/debug.py::profile_trace`` writes the records of its region as
``spans.json`` beside its ``trace.json``.
"""

from __future__ import annotations

import contextlib
import itertools
import sys
import threading
import time
from collections import deque

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

MAXLEN = 131072
PREFIX = "kde_tpu_torch."

# (key in attrs["launches"], module, its global): the launch counters of
# the port's kernels, and the twin stages some of them count
COUNTERS = (
    ("gibbs_chain", "kde_tpu_torch.ops.gibbs_chain", "LAUNCHES"),
    ("gibbs_select", "kde_tpu_torch.ops.gibbs_select", "LAUNCHES"),
    ("gibbs_select.twin", "kde_tpu_torch.ops.gibbs_select", "TWIN_STAGES"),
    ("loo_search", "kde_tpu_torch.ops.loo_search", "LAUNCHES"),
    ("loo_search.rows", "kde_tpu_torch.ops.loo_search", "ROWS_LAUNCHES"),
    ("tiled_eval", "kde_tpu_torch.ops.tiled_eval", "LAUNCHES"),
    ("host_small", "kde_tpu_torch.ops.host_small", "LAUNCHES"),
    ("sharded_select", "kde_tpu_torch.ops.sharded_select", "LAUNCHES"),
    ("sharded_select.twin", "kde_tpu_torch.ops.sharded_select",
     "TWIN_STAGES"),
    ("sharded_loo", "kde_tpu_torch.ops.sharded_loo", "LAUNCHES"),
    ("sharded_loo.twin", "kde_tpu_torch.ops.sharded_loo", "TWIN_STAGES"),
    ("tree_build", "kde_tpu_torch.ops.tree_build", "LAUNCHES"),
)

_NULL = contextlib.nullcontext()
_buffer: deque = deque(maxlen=MAXLEN)
_dropped = 0
_recording = 0
_ids = itertools.count(1)
_local = threading.local()
_now = time.perf_counter_ns


def _counters() -> dict:
    """The counters of the modules loaded so far, flat: a dict counter
    (``host_small.LAUNCHES``) gives one key per entry."""
    out = {}
    for key, mod, name in COUNTERS:
        m = sys.modules.get(mod)
        v = getattr(m, name, None) if m is not None else None
        if isinstance(v, dict):
            for k, x in v.items():
                out[f"{key}.{k}"] = x
        elif v is not None:
            out[key] = v
    return out


class _Span:
    __slots__ = ("rec", "rf", "before")

    def __init__(self, name: str, attrs: dict):
        self.rec = {"name": name, "attrs": attrs}
        self.rf = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec = self.rec
        rec["id"] = next(_ids)
        rec["parent"] = stack[-1]["id"] if stack else None
        rec["request"] = stack[-1]["request"] if stack else rec["id"]
        self.before = _counters()
        if getattr(_profiler, "_is_profiler_enabled", False):
            self.rf = record_function(PREFIX + rec["name"])
            self.rf.__enter__()
        stack.append(rec)
        rec["start_ns"] = _now()
        return rec["attrs"]

    def __exit__(self, et, ev, tb):
        global _dropped
        rec = self.rec
        rec["end_ns"] = _now()
        if self.rf is not None:
            self.rf.__exit__(et, ev, tb)
        stack = _local.stack
        if stack and stack[-1] is rec:
            stack.pop()
        before = self.before
        rec["attrs"]["launches"] = {k: v - before.get(k, 0)
                                    for k, v in _counters().items()
                                    if v != before.get(k, 0)}
        if et is not None:
            rec["error"] = et.__name__
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1
        _buffer.append(rec)
        return False


def span(name: str, **attrs):
    """A context manager around one pass through a layer boundary; its
    ``as`` target is the record's ``attrs`` when on, None when off."""
    if not (_recording or getattr(_profiler, "_is_profiler_enabled", False)):
        return _NULL
    return _Span(name, attrs)


@contextlib.contextmanager
def recording():
    """Record spans inside this block, with or without the profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def records() -> list:
    """The records kept since the last call, oldest first, in the order
    the spans closed; clears them and the count of :func:`dropped`."""
    global _dropped
    out = list(_buffer)
    _buffer.clear()
    _dropped = 0
    return out


def dropped() -> int:
    """Records that fell off the buffer since the last :func:`records`."""
    return _dropped
