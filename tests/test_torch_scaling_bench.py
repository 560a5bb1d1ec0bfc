"""The port's scaling harness, ``kde_tpu_torch/parallel/scaling_bench.py``.

``comm_table`` must count exactly the collectives a kernel-sharded product
issues: a 2-rank gloo world counts the calls and received bytes of
``pmax``/``psum``/``all_gather`` during one product, in float32 with one
chain block and in float64 over several blocks.  ``run`` starts one gloo
world per size and returns ``kde_tpu``'s result layout, writing a file only
to an explicit ``out_path``.

Worker mode: ``python tests/test_torch_scaling_bench.py --worker <rank>
<world> <store> <out>`` (torch only; tests/torch_world.py)."""
import json
import math
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_world import ROOT, assert_replicated, run_world  # noqa: E402
from torch_cpu import on_cpu  # noqa: E402,F401

OPS = ("pmax", "psum", "all_gather")
# name: (n_out, n_comp, n_iter, dtype, CHAIN_BLOCK_BYTES or None)
CASES = {"f32": (24, 40, 2, "float32", None),
         "f64_blocks": (20, 33, 1, "float64", 6000)}


def _worker(argv):
    from torch_world import worker_finish, worker_setup
    rank, out = worker_setup(argv)
    import torch
    import kde_tpu_torch as kt
    kt.config.DEVICE = "cpu"          # a worker is no pytest process
    from kde_tpu_torch.ops import gibbs
    from kde_tpu_torch.parallel import (
        KERNELS, gibbs_kernel_sharded as gks, make_mesh,
        prod_appx_ms_gibbs_kernel_sharded)
    counts = {}

    def counting(name, fn):
        def wrapped(x, mesh, axis):
            y = fn(x, mesh, axis)
            counts[name] = counts.get(name, 0) + 1
            counts["bytes"] = counts.get("bytes", 0) + y.numel() * \
                y.element_size()
            return y
        return wrapped

    for name in OPS:
        setattr(gks, name, counting(name, getattr(gks, name)))
    mesh = make_mesh(axis_name=KERNELS)
    default_block = gibbs.CHAIN_BLOCK_BYTES
    res = {}
    for case, (n_out, n_comp, n_iter, dtype, block) in CASES.items():
        gibbs.CHAIN_BLOCK_BYTES = block or default_block
        rng = np.random.default_rng(0)
        dens = [kt.kde(rng.normal(size=(2, n_comp)) + s, [0.3],
                       dtype=getattr(torch, dtype)) for s in (0.0, 0.5)]
        counts.clear()
        pts, _ = prod_appx_ms_gibbs_kernel_sharded(mesh, n_out, dens,
                                                   n_iter=n_iter, key=3)
        res[f"{case}/pts"] = pts.numpy()
        for k in OPS + ("bytes",):
            res[f"{case}/{k}"] = counts.get(k, 0)
    worker_finish(rank, out, res)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(os.path.abspath(__file__),
                     tmp_path_factory.mktemp("scaling"), world=2)


def test_every_rank_counts_the_same(world):
    assert_replicated(world)


@pytest.mark.parametrize("case", list(CASES))
def test_comm_table_counts_the_collectives(world, case, monkeypatch):
    import torch
    from kde_tpu_torch.ops import gibbs
    from kde_tpu_torch.parallel.scaling_bench import comm_table
    n_out, n_comp, n_iter, dtype, block = CASES[case]
    if block:
        monkeypatch.setattr(gibbs, "CHAIN_BLOCK_BYTES", block)
    table = comm_table(n_out, n_comp, 2, n_iter, shards=2, d=2,
                       dtype=getattr(torch, dtype))
    res = world[0]
    assert (table["chain_blocks"] > 1) == bool(block)
    calls = sum(int(res[f"{case}/{op}"]) for op in OPS)
    assert calls == table["collective_calls_per_product"]
    assert int(res[f"{case}/bytes"]) == table["total_bytes_per_product"]
    per_sel = [c["op"] for c in table["collectives_per_selection"]]
    assert len(per_sel) == 6
    for op in OPS:
        assert int(res[f"{case}/{op}"]) * len(per_sel) == \
            per_sel.count(op) * calls, op
    L = int(math.floor(math.log2(max(n_out, n_comp)))) + 1
    assert table["selections_per_chain"] == 2 * L * (1 + n_iter)
    assert np.all(np.isfinite(res[f"{case}/pts"]))


@pytest.mark.parametrize("case", list(CASES))
def test_comm_table_blocks_follow_the_route(case, monkeypatch):
    """On the card K6 keeps no [chains, width] temporary, so the table
    reads one chain block where the twins (the CPU) take several; a
    product's calls scale with the blocks.  Shapes only: no card needed."""
    import torch
    from kde_tpu_torch.ops import gibbs
    from kde_tpu_torch.parallel.scaling_bench import comm_table
    n_out, n_comp, n_iter, dtype, block = CASES[case]
    if block:
        monkeypatch.setattr(gibbs, "CHAIN_BLOCK_BYTES", block)
    kw = dict(shards=2, d=2, dtype=getattr(torch, dtype))
    card = comm_table(n_out, n_comp, 2, n_iter, device="cuda", **kw)
    twin = comm_table(n_out, n_comp, 2, n_iter, device="cpu", **kw)
    assert (card["route"], twin["route"]) == ("sharded", "twin")
    assert card["chain_blocks"] == 1
    assert (twin["chain_blocks"] > 1) == bool(block)
    assert (card["collective_calls_per_product"] * twin["chain_blocks"]
            == twin["collective_calls_per_product"])
    assert card["total_bytes_per_product"] == twin["total_bytes_per_product"]


def test_comm_table_full_width_case():
    """chip_smoke.py's phase 11a full-width case, 256 chains over 2 x
    1,000,000 at S = 1: one block on K6, 4 blocks of 64 chains on the
    twins (8 float32 temporaries of 1M candidates a chain)."""
    from kde_tpu_torch.parallel.scaling_bench import comm_table
    big = {dev: comm_table(256, 1_000_000, 2, 5, shards=1, device=dev)
           for dev in ("cuda", "cpu")}
    assert big["cuda"]["chain_blocks"] == 1
    assert big["cpu"]["chain_blocks"] == 4


def _well_formed(res, sizes):
    for key in ("date", "backend", "devices_available", "virtual_cpu_mesh",
                "config", "strong_scaling", "weak_scaling",
                "kernel_sharded_comm", "procedure", "caveat"):
        assert key in res, key
    assert res["backend"] == "gloo" and res["virtual_cpu_mesh"]
    for rows in (res["strong_scaling"], res["weak_scaling"]):
        assert [r["devices"] for r in rows] == list(sizes)
        assert all(np.isfinite(r["samples_per_s"]) and r["samples_per_s"] > 0
                   for r in rows)
        assert rows[0]["efficiency"] == 1.0
    json.dumps(res)


@pytest.fixture
def in_empty_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    before = sorted(os.listdir(ROOT))
    with open(os.path.join(ROOT, "SCALING.json"), "rb") as f:
        scaling = f.read()
    yield tmp_path
    assert sorted(os.listdir(ROOT)) == before
    with open(os.path.join(ROOT, "SCALING.json"), "rb") as f:
        assert f.read() == scaling


def test_run_returns_the_layout_and_writes_nothing(in_empty_dir):
    from kde_tpu_torch.parallel.scaling_bench import comm_table, run
    res = run(sizes=(1, 2), total_chains=16, n_comp=24, n_iter=1)
    _well_formed(res, (1, 2))
    assert res["kernel_sharded_comm"] == comm_table(16, 24, 2, 1, shards=2)
    assert os.listdir(in_empty_dir) == []


def test_run_writes_only_out_path(in_empty_dir):
    from kde_tpu_torch.parallel.scaling_bench import run
    path = in_empty_dir / "out" / "scaling.json"
    path.parent.mkdir()
    res = run(sizes=(1,), total_chains=8, n_comp=16, n_iter=1,
              out_path=str(path))
    assert os.listdir(in_empty_dir) == ["out"]
    with open(path) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    _well_formed(res, (1,))


if __name__ == "__main__" and "--worker" in sys.argv:
    _worker(sys.argv)
