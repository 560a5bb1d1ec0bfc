"""The port's native (C++) ball-tree builder, ``kde_tpu_torch/native.py`` +
``csrc/balltree.cpp``: its trees equal the port's NumPy builder and both of
``kde_tpu``'s builders array for array (exact equality), a failed build
raises instead of falling back, and host-backed densities build their trees
natively without changing a replayed product's labels."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import kde_tpu  # noqa: E402
from fixtures import gibbs_streams, load_fixture  # noqa: E402
from kde_tpu.ops import balltree as jtree  # noqa: E402
from kde_tpu.reference_impl import serial_gibbs_product  # noqa: E402
import kde_tpu_torch as kt  # noqa: E402
from kde_tpu_torch import native  # noqa: E402
from kde_tpu_torch.ops import balltree as ttree  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the fields tests/test_native_balltree.py compares
FIELDS = ("centers", "ranges", "weights", "means", "bandwidth", "left",
          "right", "lowest_leaf", "highest_leaf", "permutation", "depth",
          "bw_min", "bw_max")


def _four(pts, w, bw):
    """The port's native and NumPy trees and kde_tpu's NumPy and native
    trees of the same input; the port's native tree is built once."""
    b0 = native.BUILDS
    trees = {"port native": ttree.build_balltree(pts, w, bw),
             "port python": ttree.build_balltree(pts, w, bw,
                                                 backend="python"),
             "jax python": jtree.build_balltree(pts, w, bw,
                                                backend="python"),
             "jax native": jtree.build_balltree(pts, w, bw,
                                                backend="native")}
    assert native.BUILDS == b0 + 1
    return trees


def _assert_all_equal(trees):
    want = trees["port native"]
    for name, t in trees.items():
        assert (t.dims, t.num_points, t.multibandwidth) == \
            (want.dims, want.num_points, want.multibandwidth), name
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(t, f), getattr(want, f),
                                          err_msg=f"{name}: {f}")


@pytest.mark.parametrize("n,d", [(2, 1), (7, 2), (100, 3), (513, 4),
                                 (5000, 3)])
def test_uniform_bandwidth(n, d):
    rng = np.random.default_rng(n + d)
    pts = rng.normal(size=(n, d))
    w = rng.uniform(0.5, 1.5, size=n)
    _assert_all_equal(_four(pts, w / w.sum(), np.full(d, 0.25)))


def test_multibandwidth():
    rng = np.random.default_rng(1)
    n, d = 64, 2
    pts = rng.normal(size=(n, d))
    bw = rng.uniform(0.1, 1.0, size=(n, d))
    _assert_all_equal(_four(pts, np.full(n, 1.0 / n), bw))


def test_heavy_duplicates():
    """Tie handling in the quickselect: many equal coordinates."""
    rng = np.random.default_rng(2)
    pts = rng.integers(0, 4, size=(50, 2)).astype(float)
    _assert_all_equal(_four(pts, np.full(50, 0.02), np.full(2, 0.5)))


def test_golden_fixture():
    """The reference's 1-D golden dump (tests/test_native_balltree.py)."""
    pts = np.array([[0.1], [0.45], [0.55], [3.8]])
    trees = _four(pts, np.full(4, 0.25), np.array([0.08]) ** 2)
    _assert_all_equal(trees)
    fx = load_fixture("test1DResult.txt")
    tree = trees["port native"]
    np.testing.assert_allclose(tree.centers.reshape(-1), fx["centers"],
                               atol=1e-5)
    np.testing.assert_array_equal(tree.left, fx["left_child"].astype(int))


def test_single_point_takes_python():
    """N = 1 builds with NumPy under "auto", as in kde_tpu."""
    b0 = native.BUILDS
    t = ttree.build_balltree(np.zeros((1, 2)), np.ones(1), np.full(2, 0.1))
    assert native.BUILDS == b0 and t.num_points == 1
    with pytest.raises(ValueError, match="backend"):
        ttree.build_balltree(np.zeros((3, 1)), np.ones(3), backend="cpp")


@pytest.mark.parametrize("how", ["missing compiler", "compile error"])
def test_failed_build_raises(how, monkeypatch):
    """No silent fallback: the error carries the compiler's message."""
    monkeypatch.setattr(native, "_lib", None)
    if how == "missing compiler":
        monkeypatch.setattr(native, "CXX", "/nonexistent/g++")
        match = "nonexistent"
    else:
        monkeypatch.setattr(native, "CXX_FLAGS",
                            native.CXX_FLAGS + ["-fno-such-flag"])
        match = "no-such-flag"
    b0 = native.BUILDS
    with pytest.raises(RuntimeError, match=match):
        ttree.build_balltree(np.random.default_rng(0).normal(size=(9, 2)),
                             np.full(9, 1 / 9), np.full(2, 0.1))
    assert native.BUILDS == b0


def test_import_builds_nothing():
    code = ("import os, sys\n"
            "from pathlib import Path\n"
            "d = Path('kde_tpu_torch/_build')\n"
            "before = sorted(os.listdir(d)) if d.exists() else []\n"
            "import kde_tpu_torch\n"
            "from kde_tpu_torch import native\n"
            "from kde_tpu_torch.ops import tiled_eval\n"
            "after = sorted(os.listdir(d)) if d.exists() else []\n"
            "assert native._lib is None and native.BUILDS == 0\n"
            "assert tiled_eval._lib is None\n"
            "assert before == after, (before, after)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_kde_tree_builds_natively():
    rng = np.random.default_rng(3)
    p = kt.kde(rng.normal(size=(2, 300)), [0.2], dtype=torch.float64)
    b0 = native.BUILDS
    tree = p.tree
    assert native.BUILDS == b0 + 1
    want = ttree.build_balltree(p.host_points().T, p.host_weights(),
                                p._host_var()[0], backend="python")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tree, f), getattr(want, f),
                                      err_msg=f)


def test_replayed_product_labels_unchanged():
    """Host-backed densities in replay mode: their trees are now native,
    and the labels equal those over NumPy-built trees and the serial
    oracle's (points to 1e-9)."""
    rng = np.random.default_rng(7)
    d, ns, n_out, n_iter = 2, (40, 33), 16, 2
    jdens = [kde_tpu.kde(rng.normal(size=(d, n)),
                         list(rng.uniform(0.3, 0.8, size=d))) for n in ns]
    ru, rn, _ = gibbs_streams(rng, len(ns), d, n_out, n_iter, max(ns))

    def port(python_trees):
        dens = [kt.kde_from_numpy(np.asarray(p.points), np.asarray(p.bw),
                                  np.asarray(p.weights), p.multibandwidth,
                                  dtype=torch.float64) for p in jdens]
        if python_trees:
            for k in dens:
                k._tree = ttree.build_balltree(
                    k.host_points().T, k.host_weights(), k._host_var()[0],
                    backend="python")
        return kt.prod_appx_ms_gibbs(n_out, dens, n_iter=n_iter, rand_u=ru,
                                     rand_n=rn, record_labels=True)

    b0 = native.BUILDS
    pts, idx, lab = port(python_trees=False)
    assert native.BUILDS == b0 + 2
    pts_p, idx_p, lab_p = port(python_trees=True)
    assert native.BUILDS == b0 + 2
    np.testing.assert_array_equal(idx.numpy(), idx_p.numpy())
    np.testing.assert_array_equal(lab.numpy(), lab_p.numpy())
    np.testing.assert_array_equal(pts.numpy(), pts_p.numpy())
    pts_s, idx_s, lab_s = serial_gibbs_product(
        [p.tree for p in jdens], n_out, n_iter, ru, rn)
    np.testing.assert_array_equal(idx.numpy(), idx_s)
    np.testing.assert_array_equal(lab.numpy(), lab_s)
    np.testing.assert_allclose(pts.numpy(), pts_s, rtol=1e-9, atol=1e-12)
