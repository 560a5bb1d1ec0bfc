"""The per-layer readers of the program's own spans
(``portbench/program_spans.py``): each gives a number in a traced run of
its cells at a small size, the star cells' idle split sums to the trace's
idle, an idle interval is cut at the span edges, and a reader gives None
where the program has no spans or its buffer dropped records."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from conftest import run_small

STAR = ["plan_host_ms.star", "plan_launches.star", "plan_idle_ms.star",
        "sampling_idle_ms.star", "refit_idle_ms.star", "api_idle_ms.star",
        "outside_idle_ms.star"]
IDLE = [m for m in STAR if m.endswith("_idle_ms.star")]
SERVE = ["streams_host_ms.serve", "sample_host_ms.serve"]


@pytest.fixture(scope="module")
def star():
    return run_small("star_pose2_2x20k", trace=True)


@pytest.fixture(scope="module")
def serve():
    return run_small("serve_point2_b6x1k", trace=True)


def test_the_star_readers_give_numbers(star):
    assert star["correct"], star["checks"]
    for name in STAR:
        v = star["metrics"][name]["value"]
        assert isinstance(v, float) and v >= 0.0, name
    assert star["metrics"]["plan_host_ms.star"]["value"] > 0.0
    # no card: no launches, and every idle piece of a request is in a span
    # or the harness's loop
    assert star["metrics"]["plan_launches.star"]["value"] == 0.0
    assert star["metrics"]["sampling_idle_ms.star"]["value"] > 0.0


def test_the_star_idle_split_sums_to_the_trace_idle(star):
    dev = star["device"]
    idle_s = dev["window_s"] - dev["busy_s"]
    requests = star["attempted"] - star["failed"]
    split_s = sum(star["metrics"][m]["value"] for m in IDLE) * requests / 1e3
    assert split_s == pytest.approx(idle_s, abs=1e-6)
    share = 100.0 * split_s / dev["window_s"]
    assert share == pytest.approx(star["metrics"]["idle_share.star"]["value"],
                                  abs=1e-4)


def test_the_serve_readers_give_numbers(serve):
    assert serve["correct"], serve["checks"]
    m = serve["metrics"]
    for name in SERVE:
        assert isinstance(m[name]["value"], float) and m[name]["value"] > 0
    # the program's span lies inside the harness's timer around sample()
    assert m["sample_host_ms.serve"]["value"] <= \
        m["call_host_ms.serve"]["value"]
    assert m["streams_host_ms.serve"]["value"] < \
        m["sample_host_ms.serve"]["value"]


def _event(name, ts, dur, cat="user_annotation"):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "tid": 1,
            "pid": 1}


def _synthetic():
    """A window of 100 us: the device busy over [0, 15] and [45, 100], so
    one idle interval [15, 45]; one request product [0, 40] > gibbs
    [5, 35] > plan [10, 20] (a launch at 12) then streams [20, 30]; a
    launch at 42 outside any span."""
    from portbench import trace
    evs = [_event("portbench.window", 0.0, 100.0),
           _event("kde_tpu_torch.product", 0.0, 40.0),
           _event("kde_tpu_torch.gibbs", 5.0, 30.0),
           _event("kde_tpu_torch.plan", 10.0, 10.0),
           _event("kde_tpu_torch.streams", 20.0, 10.0),
           _event("cudaLaunchKernel", 12.0, 1.0, "cuda_runtime"),
           _event("cudaLaunchKernel", 42.0, 1.0, "cuda_runtime"),
           {"name": "k", "cat": "kernel", "ts": 0.0, "dur": 15.0},
           {"name": "k", "cat": "kernel", "ts": 45.0, "dur": 55.0}]
    ctx = SimpleNamespace(trace=trace.Trace(evs))
    ctx.program_records = [{"name": "product", "parent": None}]
    return ctx


def test_an_idle_interval_is_cut_at_the_span_edges():
    from portbench import program_spans as ps
    ctx = _synthetic()
    tl = ps.timeline(ctx)
    assert tl.pieces == [(0.0, 5.0, "product"), (5.0, 10.0, "gibbs"),
                         (10.0, 20.0, "plan"), (20.0, 30.0, "streams"),
                         (30.0, 35.0, "gibbs"), (35.0, 40.0, "product"),
                         (40.0, 100.0, None)]
    assert dict(tl.idle_us) == {"plan": 5.0, "streams": 10.0,
                                "gibbs": 5.0, "product": 5.0, None: 5.0}
    assert dict(tl.roots) == {"product": 1}
    assert ps.idle_ms(ctx, "plan") == pytest.approx(0.005)
    assert ps.idle_ms(ctx, "sampling") == pytest.approx(0.010)
    assert ps.idle_ms(ctx, "api") == pytest.approx(0.010)
    assert ps.idle_ms(ctx, "outside") == pytest.approx(0.005)
    assert ps.idle_ms(ctx, "refit") == 0.0
    assert ps.launches(ctx, "plan") == 1.0
    assert ps.launches(ctx, "chains") is None


def _ctx():
    """A trace with one request's annotations and no program records."""
    from portbench import trace
    evs = [_event("portbench.window", 0.0, 100.0),
           _event("kde_tpu_torch.product", 10.0, 50.0),
           _event("kde_tpu_torch.plan", 20.0, 10.0)]
    return SimpleNamespace(trace=trace.Trace(evs))


def test_readers_give_none_without_spans(monkeypatch):
    from portbench import program_spans as ps
    from kde_tpu_torch.utils import spans
    spans.records()
    ctx = _ctx()
    assert ps.host_ms(ctx, "plan", "product") is None
    assert ps.idle_ms(ctx, "plan") is None
    assert ps.launches(ctx, "plan") is None
    # a tree whose program has no spans module
    monkeypatch.setitem(sys.modules, "kde_tpu_torch.utils.spans", None)
    ctx = _ctx()
    assert ps.records(ctx) is None and ps.idle_ms(ctx, "api") is None


def test_readers_give_none_after_drops(monkeypatch):
    from collections import deque

    from portbench import program_spans as ps
    from kde_tpu_torch.utils import spans
    monkeypatch.setattr(spans, "_buffer", deque(maxlen=2))
    with spans.recording():
        for name in ("product", "plan", "product"):
            with spans.span(name):
                pass
    ctx = _ctx()
    assert ps.host_ms(ctx, "plan", "product") is None
    assert ps.idle_ms(ctx, "plan") is None
    assert spans.records() == []
