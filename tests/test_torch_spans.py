"""The port's spans (``kde_tpu_torch/utils/spans.py``): off by default at
the cost of one flag test, on under ``torch.profiler`` or ``recording()``,
where one ``*`` gives the tree product -> gibbs -> {plan, streams, chains},
product -> kde -> {loocv.bracket, loocv.search} under one request id, in
the buffer and as ``kde_tpu_torch.*`` annotations in the profiler's
trace."""
import json
import os
import sys
import threading
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import kde_tpu_torch as kt  # noqa: E402
from kde_tpu_torch.ops import (gibbs_chain, host_small,  # noqa: E402
                               loo_search)
from kde_tpu_torch.utils import debug, spans  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = {"gibbs": "product", "plan": "gibbs", "streams": "gibbs",
        "chains": "gibbs", "kde": "product", "loocv.bracket": "kde",
        "loocv.search": "kde"}


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.records()
    yield
    spans.records()


def _beliefs(seed=0, n=48, d=2):
    rng = np.random.default_rng(seed)
    return [kt.kde(rng.normal(size=(d, n)) + 0.4 * i, 0.5) for i in range(2)]


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r["name"], []).append(r)
    return out


def test_off_by_default_records_nothing_and_calls_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(spans, "record_function",
                        lambda *a: calls.append("record_function"))
    monkeypatch.setattr(spans, "_now", lambda: calls.append("clock") or 0)
    monkeypatch.setattr(spans, "_counters",
                        lambda: calls.append("counters") or {})
    p, q = _beliefs()
    kt.product([p, q], key=1)
    assert calls == []
    assert spans.records() == [] and spans.dropped() == 0


def test_off_span_is_one_shared_null_context():
    a, b = spans.span("plan", impl="host"), spans.span("chains")
    assert a is b
    with a as attrs:
        assert attrs is None


def test_recording_gives_one_request_tree():
    p, q = _beliefs(1)
    with spans.recording():
        kt.product([p, q], key=2)
    recs = spans.records()
    names = _by_name(recs)
    assert sorted(names) == sorted(["product", *TREE])
    root = names["product"][0]
    assert root["parent"] is None and root["request"] == root["id"]
    assert root["attrs"]["ndens"] == 2 and root["attrs"]["n_out"] == 48
    ids = {r["id"]: r for r in recs}
    for r in recs:
        assert r["request"] == root["id"]
        if r is not root:
            assert ids[r["parent"]]["name"] == TREE[r["name"]]
        assert r["start_ns"] <= r["end_ns"] and "error" not in r
    # children open inside their parents and close before them
    for r in recs:
        if r["parent"] is not None:
            up = ids[r["parent"]]
            assert up["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= up["end_ns"]
    assert names["kde"][0]["attrs"]["fit"] is True
    assert names["loocv.bracket"][0]["attrs"] == {"rows": 2, "n": 48,
                                                  "launches": {}}
    assert names["gibbs"][0]["attrs"]["replay"] is False


def test_profiler_trace_holds_the_tree(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    p, q = _beliefs(2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kt.product([p, q], key=3)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = [e for e in json.loads(path.read_text())["traceEvents"]
           if str(e.get("name", "")).startswith("kde_tpu_torch.")
           and "dur" in e]
    got = {e["name"][len("kde_tpu_torch."):]: e for e in evs}
    assert sorted(got) == sorted(["product", *TREE])
    assert len({e["tid"] for e in evs}) == 1
    for child, parent in TREE.items():
        c, u = got[child], got[parent]
        assert u["ts"] <= c["ts"] and \
            c["ts"] + c["dur"] <= u["ts"] + u["dur"] + 1e-3, (child, parent)
    # the profiler being on, the buffer holds the same spans
    assert sorted(_by_name(spans.records())) == sorted(got)


def test_plan_cache_miss_then_hit():
    p, q = _beliefs(3)
    with spans.recording():
        kt.prod_appx_ms_gibbs(32, [p, q], key=4)
        kt.prod_appx_ms_gibbs(32, [p, q], key=5)
    plans = _by_name(spans.records())["plan"]
    assert [r["attrs"]["cache"] for r in plans] == ["miss", "hit"]
    assert all(r["attrs"]["impl"] == "host" for r in plans)
    assert plans[0]["request"] != plans[1]["request"]


def test_chains_take_the_twin_route_on_the_cpu():
    p, q = _beliefs(4)
    with spans.recording():
        kt.prod_appx_ms_gibbs(32, [p, q], key=6, select="gumbel")
    (ch,) = _by_name(spans.records())["chains"]
    assert ch["attrs"]["route"] == "twin"
    assert ch["attrs"]["select"] == "gumbel"
    assert ch["attrs"]["sets"] == 1 and ch["attrs"]["n_out"] == 32
    assert ch["attrs"]["widths"][-1] == 48
    assert "gibbs_chain" not in ch["attrs"]["launches"]


@pytest.mark.parametrize("batched", [True, False])
def test_sample_roots_hold_streams_and_chains(batched):
    p, q = _beliefs(5)
    with spans.recording():
        if batched:
            s = kt.BatchedProductSampler([[p, q], [q, p]], n_out=24)
        else:
            s = kt.ProductSampler([p, q], n_out=24)
        s.sample(7)
    names = _by_name(spans.records())
    (root,) = names["sample"]
    assert root["parent"] is None
    assert root["attrs"]["sets"] == (2 if batched else 1)
    for child in ("streams", "chains"):
        (r,) = names[child]
        assert r["parent"] == root["id"] and r["request"] == root["id"]
    assert names["streams"][0]["attrs"]["sets"] == (2 if batched else 1)


def test_launch_deltas_equal_the_counters_change(monkeypatch):
    monkeypatch.setattr(gibbs_chain, "LAUNCHES", gibbs_chain.LAUNCHES)
    monkeypatch.setattr(loo_search, "ROWS_LAUNCHES",
                        loo_search.ROWS_LAUNCHES)
    monkeypatch.setattr(host_small, "LAUNCHES", dict(host_small.LAUNCHES))
    with spans.recording():
        with spans.span("outer"):
            with spans.span("inner"):
                gibbs_chain.LAUNCHES += 2
                host_small.LAUNCHES["loo_golden"] += 1
            loo_search.ROWS_LAUNCHES += 1
        with spans.span("still"):
            pass
    got = {r["name"]: r["attrs"]["launches"] for r in spans.records()}
    assert got == {"inner": {"gibbs_chain": 2, "host_small.loo_golden": 1},
                   "outer": {"gibbs_chain": 2, "host_small.loo_golden": 1,
                             "loo_search.rows": 1},
                   "still": {}}


def test_an_exception_closes_the_span_with_error():
    with spans.recording():
        with pytest.raises(ValueError):
            with spans.span("outer"):
                with spans.span("inner"):
                    raise ValueError("boom")
        with spans.span("after"):
            pass
    recs = {r["name"]: r for r in spans.records()}
    assert recs["inner"]["error"] == "ValueError"
    assert recs["outer"]["error"] == "ValueError"
    assert recs["after"]["parent"] is None and "error" not in recs["after"]


def test_overflow_counts_dropped(monkeypatch):
    monkeypatch.setattr(spans, "_buffer", deque(maxlen=3))
    with spans.recording():
        for i in range(5):
            with spans.span("s", i=i):
                pass
    assert spans.dropped() == 2
    recs = spans.records()
    assert [r["attrs"]["i"] for r in recs] == [2, 3, 4]
    assert spans.dropped() == 0 and spans.records() == []
    assert spans.MAXLEN == 131072


def test_user_kde_is_a_root_with_its_sizes():
    rng = np.random.default_rng(6)
    with spans.recording():
        kt.kde(rng.normal(size=(3, 40)), 0.3)
        kt.kde(torch.as_tensor(rng.normal(size=(2, 30))))
    recs = spans.records()
    a, b = _by_name(recs)["kde"]
    assert [r["name"] for r in recs] == ["kde", "loocv.bracket",
                                         "loocv.search", "kde"]
    assert a["parent"] is None and a["attrs"]["fit"] is False
    assert (a["attrs"]["n"], a["attrs"]["d"]) == (40, 3)
    assert b["attrs"]["fit"] is True and (b["attrs"]["n"],
                                          b["attrs"]["d"]) == (30, 2)
    assert b["request"] == b["id"] != a["request"]


def test_each_thread_keeps_its_own_stack():
    seen = {}

    def other():
        with spans.span("other"):
            pass

    with spans.recording():
        with spans.span("main"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    for r in spans.records():
        seen[r["name"]] = r
    assert seen["other"]["parent"] is None
    assert seen["other"]["request"] == seen["other"]["id"]


def test_profile_trace_writes_spans_json(tmp_path):
    p, q = _beliefs(7)
    with debug.profile_trace(str(tmp_path)):
        kt.product([p, q], key=8)
    assert (tmp_path / "trace.json").is_file()
    out = json.loads((tmp_path / "spans.json").read_text())
    assert out["dropped"] == 0
    assert sorted({r["name"] for r in out["records"]}) == sorted(
        ["product", *TREE])
    assert spans.records() == []


def test_span_cost_tool_runs_both_arms_on_the_cpu():
    sys.path.insert(0, ROOT)
    from tools_torch import span_cost
    out = span_cost.run("on-off", star=2, serve=4, seed=3, device="cpu",
                        sizes={"star": {"n_pts": 40},
                               "serve": {"n_pts": 16, "n_out": 16,
                                         "block": 2}})
    assert out["card"] == "cpu" and out["mode"] == "on-off"
    assert set(out["star_ms"]) == {"on", "off"}
    assert all(len(v) == 2 for v in out["star_ms_all"].values())
    # a request: its two beliefs' kde roots and the product's eight spans
    assert out["star_records_per_request"] == 10
    assert out["serve_blocks"] == {"on": 2, "off": 2}
    assert all(v > 0 for v in out["serve_host_ms"].values())
    assert spans.records() == []
    off = span_cost.run("off", star=1, serve=2, seed=3, device="cpu",
                        sizes={"star": {"n_pts": 40},
                               "serve": {"n_pts": 16, "n_out": 16,
                                         "block": 2}})
    assert set(off["star_ms"]) == {"off"} and spans.records() == []
