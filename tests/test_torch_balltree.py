"""The port's NumPy ball tree is bit-identical to kde_tpu's Python builder
(exact equality, array for array), on random data and the golden
fixtures, uniform and multi-bandwidth."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from fixtures import load_points  # noqa: E402
from kde_tpu.ops import balltree as jtree  # noqa: E402
from kde_tpu_torch.ops import balltree as ttree  # noqa: E402

FIELDS = ("centers", "ranges", "weights", "left", "right", "lowest_leaf",
          "highest_leaf", "permutation", "means", "bandwidth", "bw_min",
          "bw_max", "depth")


def _assert_same(a, b):
    assert (a.dims, a.num_points, a.multibandwidth) == \
        (b.dims, b.num_points, b.multibandwidth)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def _both(pts, w, bw):
    return (ttree.build_balltree(pts, w, bw),
            jtree.build_balltree(pts, w, bw, backend="python"))


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("multibw", [False, True])
def test_random_trees_equal(d, multibw):
    rng = np.random.default_rng(10 + d)
    n = 97
    pts = rng.normal(size=(n, d))
    pts[5] = pts[17]                      # a duplicate point: tie handling
    w = rng.uniform(0.1, 1.0, size=n)
    w /= w.sum()
    bw = (rng.uniform(0.01, 0.5, size=(n, d)) if multibw
          else rng.uniform(0.01, 0.5, size=d))
    _assert_same(*_both(pts, w, bw))


@pytest.mark.parametrize("name,d", [("test1Dlcv100.txt", 1),
                                    ("test2Dlcv100.txt", 2),
                                    ("test2Dvarlcv100.txt", 2)])
@pytest.mark.parametrize("multibw", [False, True])
def test_fixture_trees_equal(name, d, multibw):
    pts = load_points(name).reshape(-1, d)
    n = pts.shape[0]
    w = np.full(n, 1.0 / n)
    bw = (np.linspace(0.01, 0.1, n * d).reshape(n, d) if multibw
          else np.full(d, 0.003295))
    _assert_same(*_both(pts, w, bw))


@pytest.mark.parametrize("n", [1, 2, 33])
def test_level_lists_and_bracket_equal(n):
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(n, 2))
    w = np.full(n, 1.0 / n)
    a, b = _both(pts, w, np.array([0.1, 0.2]))
    _assert_same(a, b)
    for la, lb in zip(a.level_lists(8), b.level_lists(8)):
        np.testing.assert_array_equal(la, lb)
    assert ttree.neighbor_min_max(a) == jtree.neighbor_min_max(b)
