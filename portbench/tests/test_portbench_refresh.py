"""The refreshing serving cell ``serve_point2_b6x1k_refresh`` with its timed
path broken underneath (``correct`` comes out false), its readers, the
bound of K8's plan, and the ``*`` check over every belief of a request."""

from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from conftest import ROOT, SECONDS, run_small
from test_portbench_faults import _serve_fault

CELL = "serve_point2_b6x1k_refresh"


def _stale(monkeypatch):
    """``refresh`` builds the plan of the messages of its previous call, so
    the sampler draws from the group it held before."""
    import kde_tpu_torch
    real = kde_tpu_torch.BatchedProductSampler.refresh

    def refresh(self, density_sets, *a, **kw):
        before = getattr(self, "_before", None)
        self._before = density_sets
        if before is not None:
            real(self, before, *a, **kw)
    monkeypatch.setattr(kde_tpu_torch.BatchedProductSampler, "refresh",
                        refresh)


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_refresh_fault_is_not_correct(monkeypatch, fault):
    if fault == "stale":
        _stale(monkeypatch)
    else:
        _serve_fault(monkeypatch, fault)
    out = run_small(CELL)
    assert out["attempted"] > 0
    assert not out["correct"], out["checks"]


def test_stale_reference_fails_draw_and_label_z():
    """The reference in the program's place, its refresh keeping the trees
    of the group before: ``draw_z`` and ``label_z`` read over their
    limits.  ``label_z`` grows with the calls counted, and the reference
    makes a few a second on the CPU, so the window is three times the
    cell's small one."""
    checks = run_small(CELL, control="stale",
                       seconds=3 * SECONDS[CELL])["checks"]
    assert checks["draw_z"]["value"] > checks["draw_z"]["limit"]
    assert checks["label_z"]["value"] > checks["label_z"]["limit"]


@pytest.mark.cuda
def test_one_sweep_fails_at_the_cells_size(card):
    """The reference with one sweep a level in the program's place, at the
    cell's own size on the card: at a size the CPU holds its draws and
    labels are too few to tell one sweep from five."""
    p = subprocess.run([sys.executable, "portbench/readings.py",
                        "--workload", CELL, "--control-seeds", "17",
                        "--control-kind", "one_sweep", "--control-seconds",
                        "30"], cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    assert not json.loads(p.stdout.strip().splitlines()[-1])["correct"]


def test_refresh_readers_give_numbers():
    out = run_small(CELL, trace=True)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    assert m["refresh_host_ms.refresh"]["value"] > 0.0
    # no card: no launches, and the device idles through every refresh
    assert m["refresh_launches.refresh"]["value"] == 0.0
    assert 0.0 < m["refresh_idle_ms.refresh"]["value"] <= \
        m["refresh_host_ms.refresh"]["value"] * 1.5
    assert m["idle_share.refresh"]["value"] == pytest.approx(100.0)
    assert "k8_roofline.refresh" not in m and "k3_roofline.refresh" not in m


def test_star_check_multiplies_every_belief(monkeypatch):
    """A ``*`` of three beliefs a request: the check passes the program and
    fails a program that drops the third belief."""
    small = dict(densities=3, components=1500, inputs=1)
    out = run_small("star_point2_2x20k", traffic=small)
    assert out["correct"], out["checks"]
    import kde_tpu_torch
    real = kde_tpu_torch.product

    def product(densities, add_entropy=True, key=None):
        return real(densities[:2], add_entropy=add_entropy, key=key)
    monkeypatch.setattr(kde_tpu_torch, "product", product)
    ch = run_small("star_point2_2x20k", traffic=small)["checks"]["draw_z"]
    assert ch["value"] > ch["limit"]


def _trace(spans, gaps, launches, t1=100.0):
    """A stand-in for ``trace.Trace``: a window [0, ``t1``], host events
    and idle intervals."""
    host = sorted([(a, b, "portbench.refresh") for a, b in spans]
                  + [(a, a + 1.0, "cudaLaunchKernel") for a in launches],
                  key=lambda t: (t[0], -t[1]))
    return SimpleNamespace(t0=0.0, t1=t1, _host=host, _gaps=gaps)


def test_harness_spans_cut_idle_and_count_launches():
    from portbench import harness_spans
    tr = _trace(spans=[(10.0, 30.0), (50.0, 60.0), (95.0, 120.0)],
                gaps=[(0.0, 15.0), (25.0, 55.0), (90.0, 100.0)],
                launches=[12.0, 29.0, 30.0, 40.0, 59.5, 99.0])
    # idle inside: [10, 15] + [25, 30] + [50, 55] + [95, 100] = 20 us
    assert harness_spans.idle_ms(tr, "refresh") == pytest.approx(20e-3 / 3)
    # launches at 12, 29, 59.5 and 99 began inside a span; 30 at its end
    assert harness_spans.launches(tr, "refresh") == pytest.approx(4 / 3)
    empty = _trace(spans=[], gaps=[(0.0, 100.0)], launches=[5.0])
    assert harness_spans.idle_ms(empty, "refresh") is None
    assert harness_spans.launches(empty, "refresh") is None


def test_k8_bound_by_hand():
    from portbench.bounds import k8
    from portbench.bounds.roofline import PEAKS
    # 5 points: slices 5 -> 3, 2 -> 2, 1, 1, 1 -> 1, 1: three split depths
    assert k8.split_depths(5) == 3
    assert [k8.split_depths(n) for n in (1, 2, 3, 4, 1000, 20000)] == \
        [0, 1, 2, 2, 10, 15]
    # one belief of 5 points in 2 dims, float32, 5 draws: levels 0..3
    # (floor(log2 5) + 1 = 3) hold 1 + 2 + 4 + 5 nodes; 9 slots
    node = 5 * 4 + 8
    want = 3 * 5 * 2 * 4 + (9 + 12) * node
    assert k8.plan_bytes([5], 2, 5, 4) == want
    assert k8.plan_seconds(3, [5, 5], 2, 5, 4) == pytest.approx(
        6 * want / PEAKS["hbm_bytes_per_s"])


def test_k8_share_reads_k8_kernels_only():
    from portbench.bounds import k8
    from portbench.layer_metrics_k8 import k8_share
    from portbench.trace import Trace
    evs = [{"name": "portbench.window", "cat": "user_annotation", "ts": 0.0,
            "dur": 1000.0, "tid": 1, "pid": 1},
           {"name": "void multi_sort_kernel<float>", "cat": "kernel",
            "ts": 10.0, "dur": 30.0},
           {"name": "void levels_kernel<float>", "cat": "kernel",
            "ts": 50.0, "dur": 10.0},
           {"name": "void gibbs_chain_kernel<float>", "cat": "kernel",
            "ts": 100.0, "dur": 500.0}]
    plan = dict(sets=6, npts=[1000, 1000], d=2, n_out=1000, itemsize=4)
    share = k8_share(Trace(evs), [plan, plan])
    assert share == pytest.approx(100.0 * 2 * k8.plan_seconds(**plan)
                                  / 40e-6)
    assert k8_share(Trace(evs[:1] + evs[3:]), [plan]) is None
