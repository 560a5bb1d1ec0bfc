"""The torch twins of ``examples/*.py`` in ``examples_torch/``: each runs on
the CPU at a small size with its script's own checks, the consensus twin's
sharded branch runs in a 2-rank gloo world, and no twin imports JAX or the
JAX package.

Worker mode: ``python tests/test_torch_examples.py --worker <rank> <world>
<store> <out>`` (torch only; tests/torch_world.py)."""
import ast
import importlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_world import ROOT, assert_replicated, run_world  # noqa: E402
from torch_cpu import on_cpu  # noqa: E402,F401

TWINS = ("belief_propagation", "circular_fusion", "consensus_example",
         "evaluating_densities", "extracting_labels", "profile_products",
         "readme_examples", "se2_fusion")
# small sizes for the CPU; the twins' checks hold at these
SIZES = {"belief_propagation": dict(n=64),
         "circular_fusion": dict(n=100),
         "consensus_example": dict(n=80),
         "evaluating_densities": dict(n_1d=60, n_3d=40),
         "extracting_labels": {},
         "profile_products": dict(configs=((50, 50, 1), (200, 100, 2)),
                                  reps=2),
         "readme_examples": dict(n=60, n_beta=120, n_ray=60, n_4d=80),
         "se2_fusion": dict(n=150)}
CONSENSUS_N = 60


def test_every_example_has_a_twin():
    names = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "examples"))
                   if f.endswith(".py"))
    assert names == sorted(TWINS)


@pytest.mark.parametrize("name", TWINS)
def test_twin_runs_on_cpu(name, capsys):
    mod = importlib.import_module(f"examples_torch.{name}")
    out = mod.main(**SIZES[name])
    assert isinstance(out, dict) and out
    assert capsys.readouterr().out.strip()


def test_profile_products_labels_every_number(capsys):
    from examples_torch import profile_products
    rows = profile_products.main(configs=((40, 30, 1),), reps=1)["rows"]
    assert rows[0]["device"] == "cpu, host clock"
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines and all(ln.endswith("[cpu, host clock]") for ln in lines)


def test_consensus_single_process_is_unsharded():
    from examples_torch import consensus_example
    out = consensus_example.main(n=CONSENSUS_N)
    assert out["world"] == 1 and out["points"].shape == (1, CONSENSUS_N)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_no_jax(name):
    path = os.path.join(ROOT, "examples_torch", f"{name}.py")
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "kde_tpu")]
    assert not bad, bad


# ---------------------------------------------------------------------------
# the consensus twin's sharded branch
# ---------------------------------------------------------------------------

def _worker(argv):
    from torch_world import worker_finish, worker_setup
    rank, out = worker_setup(argv)
    import kde_tpu_torch as kt
    kt.config.DEVICE = "cpu"          # a worker is no pytest process
    from examples_torch import consensus_example
    res = consensus_example.main(n=CONSENSUS_N)
    worker_finish(rank, out, {"points": res["points"],
                              "world": res["world"],
                              "support": np.array(res["support"])})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(os.path.abspath(__file__),
                     tmp_path_factory.mktemp("examples"), world=2)


def test_consensus_sharded_branch(world):
    """Both ranks take the chain-sharded branch and return the whole
    product, bitwise the same."""
    assert_replicated(world)
    res = world[0]
    assert int(res["world"]) == 2
    assert res["points"].shape == (1, CONSENSUS_N)
    assert np.all(np.isfinite(res["points"]))


if __name__ == "__main__" and "--worker" in sys.argv:
    _worker(sys.argv)
