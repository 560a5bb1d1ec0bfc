"""``tools_torch/scale_envelope.py`` on the CPU: the rule's fit recovers a
synthetic mem table, the shard solver finds the smallest N that takes two
shards, the mem rows' estimate columns are ``estimate_product_memory``'s,
and every stage raises without a card (the allocator's peak, the times and
the NCCL world exist only there)."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from torch_cpu import on_cpu  # noqa: E402,F401

from kde_tpu_torch.ops import gibbs  # noqa: E402
from kde_tpu_torch.parallel import sizing  # noqa: E402
from tools_torch import scale_envelope as se  # noqa: E402


def test_rule_recovers_a_synthetic_mem_table():
    c0, c1, per_plan, per_args = 3.5e6, 7.25, 96.5, 600.0
    rows = []
    for n in se.NS:
        x = se.N_OUT * 2.0 * n
        rows.append(dict(N=n, select="cdf", peak=c0 + c1 * x,
                         total=2 * c0 + 1.5 * c1 * x, plan=per_plan * 2 * n,
                         args=1000 + per_args * 2 * n))
        rows.append(dict(N=n, select="gumbel", peak=1.0, total=1.0, plan=0,
                         args=0))
    rows.append(dict(N=10**7, select="cdf", error="OutOfMemoryError"))
    fit = se.fit_rule(rows)
    np.testing.assert_allclose(
        [fit["c0"], fit["c1"], fit["plan_per_component"],
         fit["model_c0"], fit["model_c1"], fit["model_args_per_component"]],
        [c0, c1, per_plan, 2 * c0, 1.5 * c1, per_args], rtol=1e-9)
    n = se.fit_budget_n(fit, 10**9)
    assert c0 + c1 * se.N_OUT * 2 * (n - 1) < 10**9 <= (
        c0 + c1 * se.N_OUT * 2 * n)
    with pytest.raises(ValueError, match="two cdf rows"):
        se.fit_rule(rows[:2])


@pytest.mark.parametrize("budget", [5 * 10**7, 3 * 10**9])
def test_shard_solver_finds_the_smallest_two_shard_n(budget, monkeypatch):
    monkeypatch.setattr(sizing, "default_hbm_budget", lambda dev: budget)
    got = se.two_shard_n(torch.device("cpu"))
    n = got["N"]
    assert got["budget"] == budget
    assert got["at_N"]["shards"] == 2 and got["below"]["shards"] == 1
    total = lambda k: sizing.product_bytes(
        (k, k), se.D, se.N_OUT, se.N_ITER, torch.float32, "auto", "device",
        "cpu")["total"]
    assert total(n - 1) <= budget < total(n)
    assert got["at_N"]["bytes"] == total(n)


def test_mem_columns_are_the_estimate(monkeypatch):
    """The mem row's args/temp/out/total are estimate_product_memory's
    for the densities the row draws from, ``plan`` is the bytes of the
    plan it built, and the ratio is the total over the peak (here a
    stand-in: the CPU has no allocator peak)."""
    monkeypatch.setattr(se, "peak_bytes", lambda fn, dev: (fn(), 10**6)[1])
    for select in ("cdf", "gumbel"):
        gibbs._plan_cache.clear()
        row = se.mem_row(3000, select, torch.device("cpu"))
        dens = se._dens(3000, "cpu")
        est = sizing.estimate_product_memory(dens, se.N_OUT,
                                             n_iter=se.N_ITER,
                                             dtype=torch.float32,
                                             select=select)
        assert {k: row[k] for k in ("args", "temp", "out", "total")} == {
            k: est[k] for k in ("args", "temp", "out", "total")}
        assert row["ratio"] == est["total"] / 10**6
        plan = gibbs._get_plan(dens, se.N_OUT, torch.float32,
                               torch.device("cpu"), "device")
        assert row["plan"] == (sum(getattr(plan, f).nbytes
                                   for f in gibbs._PLAN_TENSORS)
                               + plan.lvl_uniform.nbytes)
    gibbs._plan_cache.clear()


def test_crossover_reads_the_first_n_a_mode_wins():
    rows = [dict(N=n, select=s, samples_per_s=r) for n, s, r in (
        (1, "cdf", 10.0), (1, "gumbel", 5.0), (1, "blocked", 1.0),
        (2, "cdf", 8.0), (2, "gumbel", 9.0), (2, "blocked", 1.0),
        (4, "cdf", 6.0), (4, "gumbel", 7.0))]
    assert se.crossover(rows) == {"blocked": None, "gumbel": 2}


@pytest.mark.parametrize("stage", ["mem", "time", "sharded", "rule"])
def test_every_stage_raises_without_a_card(stage, tmp_path):
    assert not torch.cuda.is_available()
    fn = {"mem": se.mem_stage, "time": se.time_stage,
          "sharded": se.sharded_stage, "rule": se.rule_stage}[stage]
    with pytest.raises(RuntimeError, match="CUDA card"):
        fn()
    out = tmp_path / "env.jsonl"
    with pytest.raises(RuntimeError, match="CUDA card"):
        se.main([stage, "--out", str(out)])
    assert not out.exists()
