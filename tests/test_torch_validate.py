"""``tools_torch/validate_cuda.py``, the card's statistical acceptance of
float32 products, on the CPU at its small rows (the twin runs each draw).

Its brackets equal the JAX tool's (``tools/validate_tpu.py``, loaded by
path: its module top imports no JAX); the reference grid, the circular row
and the kernel-sharded row (two gloo ranks here) pass their votes and the
hook-free control fails them; every row records ``launch_plan``'s layout
for its shape, and the rows cover K3's three layouts; without a card the
tool raises and writes nothing.

Worker mode: ``python tests/test_torch_validate.py --worker <rank> <world>
<store> <out>`` (torch only; tests/torch_world.py)."""
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "tests"), ROOT]
from torch_world import run_world  # noqa: E402
from torch_cpu import on_cpu  # noqa: E402,F401

from kde_tpu_torch.ops import gibbs_chain  # noqa: E402
from tools_torch import validate_cuda as vc  # noqa: E402


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "validate_tpu", os.path.join(ROOT, "tools", "validate_tpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_brackets_equal_the_jax_tools():
    jt = _jax_tool()
    assert "jax" not in jt.__dict__
    rng = np.random.default_rng(0)
    for i in range(20):
        D, M = 2 + i % 3, 2 + i % 5
        scale = np.sqrt(1.0 / M) * rng.uniform(0.4, 1.6)
        pts = rng.normal(size=(D, 50)) * scale + rng.normal(scale=0.3)
        assert vc.moment_ok(pts, D, M) == jt.moment_ok(pts, D, M)
        dev = rng.uniform(0.5, 2.0)
        assert vc.moment_ok(pts * dev, D, M, dev) == jt.moment_ok(
            pts * dev, D, M, dev)
        a = rng.uniform(-20, 20, size=30)
        np.testing.assert_array_equal(vc._wrap(a), jt._wrap(a))


def test_circ_ok_is_the_jax_tools_formula():
    """tools/validate_tpu.py:135-146, written out."""
    rng = np.random.default_rng(1)
    seen = set()
    for i in range(40):
        M = 2 + i % 3
        noise = vc.NOISE * rng.uniform(0.5, 2.0)
        th = np.pi + rng.normal(scale=rng.uniform(0.01, 0.2), size=80) \
            + rng.normal(scale=0.05)
        dev = float(np.hypot(noise, 0.1))
        prod_dev = dev / np.sqrt(M)
        d = th - np.pi
        d = d - 2.0 * np.pi * np.round(d / (2.0 * np.pi))
        want = bool(abs(d.mean()) < prod_dev
                    and 0.66 * prod_dev < d.std() < 1.33 * prod_dev)
        assert vc.circ_ok(th, M, noise) == want
        seen.add(want)
    assert seen == {True, False}


@pytest.mark.parametrize("name", ["grid D2 M2 host",
                                  "grid D3 M6 mcmc10 host",
                                  "grid D2 M2 device", "circular M=2"])
def test_rows_pass_their_vote(name):
    rec = vc.run_row(vc.BY_NAME[name], "cpu")
    assert rec["passed"] and rec["wins"] >= 5, rec
    assert rec["of"] == 10 and rec["need"] == ">= 5"


def test_negative_control_fails_the_brackets():
    rec = vc.run_row(vc.BY_NAME["control circular M=2 no hooks"], "cpu")
    assert rec["wins"] <= 2 and rec["passed"], rec
    # the same data with the hooks lands in bracket
    assert vc.run_row(vc.BY_NAME["circular M=2"], "cpu")["wins"] >= 5


@pytest.mark.parametrize("name", ["gumbel grid D2 M2 host",
                                  "gumbel circular M=2", "gumbel se2 M=3"])
def test_gumbel_rows_pass_their_vote(name):
    """Keyed gumbel products (labels from the counter noise) hold the
    brackets by the votes of the rows they repeat."""
    rec = vc.run_row(vc.BY_NAME[name], "cpu")
    assert rec["select"] == "gumbel" and rec["row"] == "H"
    assert rec["passed"] and rec["wins"] >= 5, rec


def test_gumbel_control_fails_the_brackets():
    rec = vc.run_row(vc.BY_NAME["gumbel control circular M=2 no hooks"],
                     "cpu")
    assert rec["wins"] <= 2 and rec["passed"] and rec["need"] == "<= 2", rec


def test_layouts_are_launch_plans_and_cover_k3():
    """Every row's layout is ``launch_plan`` of its chains and widest
    level (the host plan's, built here for the small rows); the grid, the
    manifolds and the headline take the warp layout, the large rows the
    block layout, the C rows the staged layout."""
    for row in vc.ROWS:
        want = gibbs_chain.launch_plan(
            row.chains, vc.widest_level(row.chains, row.npts), torch.float32,
            row.d)
        assert vc.layout(row) == want, row.name
    kinds = {}
    for row in vc.ROWS:
        kinds.setdefault(row.group, set()).add(vc.layout(row))
    assert kinds["B"] == {"block"} and kinds["C"] == {"staged"}
    assert kinds["A"] == kinds["D"] == kinds["E"] == {"warp"}
    assert kinds["H"] == {"warp", "block", "staged"}
    assert {r.select for r in vc.ROWS} == {"cdf", "gumbel"}
    assert all((r.group == "H") == (r.select == "gumbel") for r in vc.ROWS)
    quick = [vc.BY_NAME[n] for n in vc.QUICK]
    for select in ("cdf", "gumbel"):
        assert {vc.layout(r) for r in quick if r.select == select} == {
            "warp", "block", "staged"}
    from kde_tpu_torch import kde
    from kde_tpu_torch.ops import gibbs
    rng = np.random.default_rng(2)
    for row in (r for r in vc.ROWS if max(r.npts) <= 1000):
        dens = [kde(rng.normal(size=(row.d, n)), [0.3], dtype=torch.float32)
                for n in row.npts]
        plan = gibbs._get_plan(dens, row.chains, torch.float32,
                               torch.device("cpu"))
        assert vc.widest_level(row.chains, row.npts) == max(
            w for _, w in plan.offsets), row.name
    gibbs._plan_cache.clear()


def test_sharded_row_in_a_gloo_world(tmp_path):
    res = run_world(os.path.abspath(__file__), tmp_path, world=2,
                    timeout=240)
    wins = [int(r["wins"]) for r in res]
    assert wins[0] == wins[1] and wins[0] >= 5, wins


def test_without_a_card_it_raises_and_writes_nothing(tmp_path):
    out = tmp_path / "v.json"
    before = os.path.exists(vc.OUT) and os.stat(vc.OUT).st_mtime_ns
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA card"):
        vc.main(["--out", str(out)])
    with pytest.raises(RuntimeError, match="CUDA card"):
        vc.run_row(vc.BY_NAME["circular M=2"], None)
    assert not out.exists()
    assert (os.path.exists(vc.OUT) and os.stat(vc.OUT).st_mtime_ns) == before


def test_out_writes_only_that_file(tmp_path):
    out = tmp_path / "v.json"
    before = os.path.exists(vc.OUT) and os.stat(vc.OUT).st_mtime_ns
    assert vc.main(["--out", str(out)], device="cpu",
                   names=("circular M=2",)) == 0
    assert (os.path.exists(vc.OUT) and os.stat(vc.OUT).st_mtime_ns) == before
    assert sorted(os.listdir(tmp_path)) == ["v.json"]
    import json
    rec = json.loads(out.read_text())
    assert rec["pass"] and rec["card"] == "cpu" and rec["dtype"] == "float32"
    assert [r["name"] for r in rec["rows"]] == ["circular M=2"]
    assert rec["rows"][0]["layout"] == "warp"


def _worker(argv):
    from torch_world import worker_finish, worker_setup
    rank, out = worker_setup(argv)
    import kde_tpu_torch as kt
    kt.config.DEVICE = "cpu"          # a worker is no pytest process
    wins = vc.sharded_wins(next(r for r in vc.ROWS if r.group == "F"),
                           "cpu")
    worker_finish(rank, out, {"wins": wins})


if __name__ == "__main__" and "--worker" in sys.argv:
    _worker(sys.argv)
