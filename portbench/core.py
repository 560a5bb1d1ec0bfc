"""The benchmark's registry and one run of a cell.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in the file the configuration names, its traffic mix in
``traffic/<mix>.json``, the code that drives that kind of traffic in
``drivers/<driver>.py``, each end-to-end metric in ``end_to_end/<name>.py``,
each per-layer metric in ``layer_metrics/<name>.py`` and the cell's limits
in ``limits/<cell>.json``.  A new configuration, mix, cell or metric is a
new file and a new entry; no file here changes.

A new cell is, and needs no more than:

- its entry in ``BENCHMARK.json``'s ``workloads``, and its name appended to
  the ``workloads`` list of each end-to-end metric it reports;
- ``traffic/<mix>.json`` for a new mix, ``limits/<cell>.json``, and its
  size on the CPU in ``small/<cell>.json`` (``{"traffic": {...},
  "seconds": s}``, read by the tests);
- ``drivers/<driver>.py`` where its kind of traffic is new (``prepare``,
  ``window``, ``control``, ``release``, ``check``);
- ``layer_metrics/<name>.py`` and an entry for each new per-layer metric;
- a new test file under ``tests/`` for the faults planted in its timed
  path.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kde_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The module at ``path``, loaded under a name of its own."""
    name = "portbench_" + "_".join(path.relative_to(HERE).with_suffix("")
                                   .parts).replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""
    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: str
    bench: dict = field(repr=False, default_factory=dict)

    @property
    def dtype(self):
        import torch
        return getattr(torch, self.config["dtype"])

    def circ(self):
        import torch
        return torch.tensor([d["hook"] == "circular"
                             for d in self.config["dims"]],
                            device=self.device)

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]


def cell(name: str, seed: int, device: str, traffic=None,
         limits=None) -> Cell:
    """The cell ``name``: its entry and files.  ``traffic`` and ``limits``
    update what the files give (the tests run cells at a small size)."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    tr = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    tr.update(traffic or {})
    lim_path = HERE / "limits" / f"{name}.json"
    lim = load_json(lim_path) if lim_path.exists() else {}
    lim.update(limits or {})
    return Cell(name, entry, config, tr, lim, int(seed), device, bench)


def driver(c: Cell):
    return load_module(HERE / "drivers" / f"{c.traffic['driver']}.py")


class Spans:
    """The harness's own spans: seconds by name, kept in memory."""

    def __init__(self):
        self.by = {}

    def add(self, name: str, seconds: float):
        self.by.setdefault(name, []).append(seconds)


def power_limit_w():
    """The card's power limit by ``nvidia-smi``, or None where it cannot
    say."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def sync(device: str):
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def run(c: Cell, seconds: float, trace: bool, t_start: float,
        control: str | None = None) -> dict:
    """One run of cell ``c``: set-up, the measured window of ``seconds``
    (under the profiler when ``trace``), the check, then the metrics.
    ``control`` names a variant of the plain reference
    (``reference.msgibbs.VARIANTS``: ``bfloat16``, the reference one
    precision below the configuration's, or a fault planted in it) to put in
    the program's place; such a run measures nothing.  Returns the result's
    fields."""
    import torch
    from . import trace as tr
    drv = driver(c)
    state = drv.prepare(c)
    sync(c.device)
    setup_s = time.perf_counter() - t_start
    spans = Spans()
    prof = None
    if control:
        win = drv.control(state, seconds, control)
    elif trace:
        prof = tr.profiler(c.device)
        with prof:
            with torch.profiler.record_function(tr.WINDOW):
                win = drv.window(state, seconds, spans)
    else:
        win = drv.window(state, seconds, spans)
    device = {"platform": "gpu" if c.device == "cuda" else c.device,
              "kind": (torch.cuda.get_device_name() if c.device == "cuda"
                       else "cpu"),
              "count": 1,
              "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                    if c.device == "cuda" else 0)}
    if c.device == "cuda":
        device["power_limit_w"] = power_limit_w()
    parsed = None
    if prof is not None:
        parsed = tr.Trace(tr.events(prof))
        del prof
        device.update(busy_s=parsed.busy_s, window_s=parsed.window_s)
    drv.release(state)
    if c.device == "cuda":
        torch.cuda.empty_cache()
    checks, facts = drv.check(state, win)
    correct = (win.attempted > 0 and win.failed == 0
               and all(ch["value"] <= ch["limit"] for ch in checks))
    record = dict(setup_s=setup_s, window_s=win.window_s,
                  latency_ms=win.latency_ms, samples=win.samples,
                  requests=win.attempted - win.failed)
    metrics = {}
    if trace:
        ctx = SimpleNamespace(cell=c, trace=parsed, spans=spans.by,
                              work=win.work, facts=facts, record=record)
        for m in c.per_layer():
            v = load_module(HERE / "layer_metrics" / f"{m['name']}.py"
                            ).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in c.end_to_end():
            v = load_module(HERE / "end_to_end" / f"{m['name']}.py"
                            ).read(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(win.attempted),
           "failed": int(win.failed), "metrics": metrics, "device": device}
    if parsed is not None:
        out["breakdown"] = parsed.breakdown()
    out["checks"] = {ch["name"]: {"value": ch["value"], "limit": ch["limit"]}
                     for ch in checks}
    return out


@dataclass
class Window:
    """What a driver's window gives back: counts, the window's seconds, the
    latency of each request, the samples completed, the outputs kept for
    the check, and a description of the work for the per-layer readers."""
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    latency_ms: list = field(default_factory=list)
    samples: int = 0
    kept: dict = field(default_factory=dict)
    work: dict = field(default_factory=dict)


def checked(name: str, value: float, limits: dict) -> dict:
    """One number compared, beside its limit; a NaN or an infinity reads
    as 1e308, which fails any limit and stays valid JSON."""
    v = float(value)
    return {"name": name, "value": v if abs(v) < float("inf") else 1e308,
            "limit": float(limits[name])}


class Reservoir:
    """A sample of at most ``k`` items of a stream, drawn from ``seed``
    (Algorithm R), so which requests are checked is fixed by the seed and
    the number of requests."""

    def __init__(self, k: int, seed: int):
        import numpy as np
        self.k, self.items, self.seen = k, {}, 0
        self.rng = np.random.default_rng(seed % (1 << 63))

    def slot(self):
        """The slot that the stream's next item takes, or None where it is
        not kept."""
        s = self.seen
        if s >= self.k:
            s = int(self.rng.integers(0, self.seen + 1))
        self.seen += 1
        return s if s < self.k else None

    def offer(self, index: int, item):
        s = self.slot()
        if s is not None:
            self.items[s] = (index, item)

    def filled(self) -> int:
        """How many slots hold an item."""
        return min(self.seen, self.k)

    def values(self):
        return [self.items[k] for k in sorted(self.items)]
