"""Every cell of BENCHMARK.json runs end to end at a small size through the
port's CPU twins, and gives the result line the contract names."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT, SMALL, run_small

CELLS = sorted(SMALL)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_cell_has_a_small_size():
    """Every cell of BENCHMARK.json has its file in ``portbench/small/``,
    and every such file names a cell."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert sorted(w["name"] for w in bench["workloads"]) == CELLS


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(name, trace):
    out = run_small(name, trace=trace)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == want
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["count"] == 1
    for name_, ch in out["checks"].items():
        assert ch["value"] <= ch["limit"], name_
    from portbench import core
    c = core.cell(name, 1, "cpu")
    kind = c.per_layer() if trace else c.end_to_end()
    assert set(out["metrics"]) <= {m["name"] for m in kind}
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in kind}
    else:
        assert out["device"]["window_s"] > 0
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The plain reference in bfloat16 in the program's place fails the
    check: the limits separate the program from the next precision down."""
    out = run_small(name, control="bfloat16")
    assert not out["correct"], out["checks"]


def test_no_jax_after_a_run():
    from portbench import core
    run_small("serve_point2_b6x1k")
    assert core.forbidden_modules() == []


def test_main_prints_the_result_last(monkeypatch, capsys):
    """``run.py``'s main path, with the look for a card answered yes and the
    cell run on the CPU: the last line of standard output is the result,
    and standard error ends with each compared number and its limit."""
    import time

    import torch

    from portbench import core, run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    real_cell = core.cell
    monkeypatch.setattr(core, "cell", lambda name, seed, device: real_cell(
        name, seed, "cpu", traffic=SMALL[name]))
    real_run = core.run
    monkeypatch.setattr(core, "run", lambda c, s, t, t0: real_run(
        c, s, t, time.perf_counter()))
    rc = run.main(["--workload", "fit_point2_100k", "--seed", "5",
                   "--seconds", "0.5", "--trace", "0"])
    cap = capsys.readouterr()
    assert rc == 0
    out = json.loads(cap.out.strip().splitlines()[-1])
    assert list(out) == KEYS + ["checks"]
    assert cap.err.strip().splitlines()[-1].startswith("check bw_rel ")


def test_main_refuses_without_a_card(monkeypatch, capsys):
    import torch

    from portbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "fit_point2_100k", "--seed", "5",
                   "--seconds", "0.5", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_serve_cell_on_the_card(card):
    """The command as the benchmark runs it, on the card, for two seconds."""
    import subprocess
    import sys
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "serve_point2_b6x1k", "--seed", "7", "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
