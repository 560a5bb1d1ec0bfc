"""The traced run: ``torch.profiler`` over the measured window, and what the
per-layer readers take from its trace.

The window is marked by the annotation ``portbench.window``.  Device busy
time is the union of the kernels', copies' and sets' intervals inside it
(the arithmetic of the port's ``chip_smoke.py::_device_idle``).  An idle gap
is named by the innermost host event (an operator, an annotation of the
harness or a runtime call) open on the window's thread when the gap began.
The trace file goes to a temporary directory under ``TMPDIR`` and is
deleted once read.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def profiler(device: str):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def events(prof) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _merged(spans):
    spans = sorted(spans)
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The window of one traced run: ``window_s``, ``busy_s``, the device
    events ``(name, start_us, dur_us)`` inside it, and the breakdown."""

    def __init__(self, evs):
        win = [e for e in evs if e.get("name") == WINDOW
               and e.get("cat") in ("user_annotation", "cpu_op")]
        if not win:
            raise RuntimeError("the trace has no window annotation")
        w = max(win, key=lambda e: e.get("dur", 0))
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.window_s = (self.t1 - self.t0) / 1e6
        self.device = []
        for e in evs:
            if e.get("cat") in DEVICE_CATS and "dur" in e:
                a = max(float(e["ts"]), self.t0)
                b = min(float(e["ts"]) + float(e["dur"]), self.t1)
                if b > a:
                    self.device.append((e["name"], a, b - a))
        busy = _merged([(a, a + d) for _, a, d in self.device])
        self.busy_s = sum(b - a for a, b in busy) / 1e6
        self._gaps = self._gaps_of(busy)
        self._host = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
              e["name"]) for e in evs
             if e.get("cat") in HOST_CATS and e.get("tid") == w.get("tid")
             and e.get("pid") == w.get("pid") and "dur" in e),
            key=lambda t: (t[0], -t[1]))

    def _gaps_of(self, busy):
        gaps, t = [], self.t0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            gaps.append((t, self.t1))
        return gaps

    def kernel_seconds(self, *patterns) -> float:
        """Device seconds of the events whose name holds any of
        ``patterns``."""
        return sum(d for n, _, d in self.device
                   if any(p in n for p in patterns)) / 1e6

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def device_ops(self):
        by = defaultdict(float)
        for n, _, d in self.device:
            by[n[:160]] += d / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])

    def idle_gaps(self):
        """Idle seconds by the innermost host event open when each gap
        began."""
        by = defaultdict(float)
        starts = [h[0] for h in self._host]
        stack, k = [], 0
        for a, b in self._gaps:
            while k < len(self._host) and starts[k] <= a:
                h = self._host[k]
                while stack and stack[-1][1] <= h[0]:
                    stack.pop()
                stack.append(h)
                k += 1
            while stack and stack[-1][1] <= a:
                stack.pop()
            name = stack[-1][2] if stack else "(no host event)"
            by[name[:160]] += (b - a) / 1e6
        return sorted(([k_, v] for k_, v in by.items()), key=lambda kv: -kv[1])

    def breakdown(self):
        return {"device_ops": self.device_ops()[:TOP],
                "idle_gaps": self.idle_gaps()[:TOP]}

