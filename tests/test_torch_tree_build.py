"""K8 ``ops/tree_build.py`` on the CPU: the launch plan's routes and shared
memory, the kernel's walk of the recursion ``split = (lo + hi) // 2``
against the topology the twin uploads, the twin (``ops/device_plan.py``'s
eager build) against the JAX package's ``device_tree_stats`` and against
the median-split check the card tests hold K8 to on tied spreads, and the
workspace the sizing model counts for the card.  The kernels themselves
run in tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from median_split import (  # noqa: E402
    equal_spread_points, median_split_violations)
from torch_cpu import on_cpu  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
from kde_tpu.ops import device_plan as jdp  # noqa: E402
from kde_tpu_torch.ops import device_plan, tree_build  # noqa: E402
from kde_tpu_torch.parallel import sizing  # noqa: E402
from kde_tpu_torch.utils import spans  # noqa: E402

F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 33, 512, 513, 1000, 20_000,
                               100_000, 1_000_000])
def test_launch_plan_routes_by_slice_width(n, dtype):
    """Every depth that splits has a row; slices wider than
    ``SUBTREE_MAX_WIDTH`` take the multi-block route, the rest the subtree
    launch; every shared-memory launch fits a block (232,448 bytes)."""
    plan = tree_build.launch_plan(n, 3, dtype)
    item = torch.empty((), dtype=dtype).element_size()
    limit = tree_build.SUBTREE_MAX_WIDTH
    depths = max(0, (n - 1).bit_length())
    assert [r["depth"] for r in plan] == list(range(depths))
    for r in plan:
        assert r["width"] == -(-n // (1 << r["depth"]))
        assert r["route"] == ("multi" if r["width"] > limit else "subtree")
        assert 0 < r["smem_bytes"] <= tree_build.SMEM_MAX_BYTES
        assert r["bytes"] == n * 3 * item + 8 * n
    sub = [r for r in plan if r["route"] == "subtree"]
    assert len({r["smem_bytes"] for r in sub}) <= 1
    if sub:
        assert sub[0]["smem_bytes"] == tree_build.subtree_smem(
            sub[0]["width"], item)
    assert plan == tree_build.launch_plan(n, 3, dtype)


def test_launch_plan_of_the_star_cells():
    """2 x 20,000 points, float32 or float64: six depths on the
    multi-block route, then the subtree launch on slices of 313; 100,000
    take eight, 1,000,000 eleven; 512 and fewer none."""
    multi = lambda n, dtype=F32: sum(
        r["route"] == "multi" for r in tree_build.launch_plan(n, 2, dtype))
    for dtype in (F32, F64):
        assert multi(20_000, dtype) == 6
        rows = tree_build.launch_plan(20_000, 2, dtype)
        assert rows[6]["width"] == 313 and rows[6]["route"] == "subtree"
    assert (multi(100_000), multi(1_000_000), multi(512), multi(513)) == (
        8, 11, 0, 1)


def test_launch_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        tree_build.launch_plan(100, 2, torch.float16)


def _topology_slices(n):
    """Per depth, the (lo, hi) of the slices the twin's topology uploads."""
    out = []
    for pd in device_plan._topology(n)["per_depth"]:
        if pd is None:
            out.append([])
            continue
        lo = pd["idx"][:, 0]
        out.append(list(zip(lo.tolist(),
                            (lo + pd["count"].astype(np.int64) - 1).tolist())))
    return out


@pytest.mark.parametrize("ns", [range(1, 101), range(101, 201),
                                range(201, 301), (20_000,)])
def test_slice_bounds_equal_the_topology(ns):
    """The kernel's walk gives, depth by depth, exactly the slices of
    ``_topology(n)``, and the launch plan counts them."""
    for n in ns:
        want = _topology_slices(n)
        depths = max(len(want), (n - 1).bit_length())
        for k in range(depths + 1):
            got = tree_build.slice_bounds(n, k)
            assert got == (want[k] if k < len(want) else []), (n, k)
        plan = tree_build.launch_plan(n, 2, F32)
        assert [r["slices"] for r in plan] == [len(w) for w in want if w], n


def _inputs(rng, n, d, ties=False):
    pts = rng.normal(size=(n, d)) * np.linspace(1.0, 2.5, d)
    if ties:
        pts = np.round(pts * 2) / 2
        pts[n // 3:n // 3 + n // 4] = pts[0]
    var = np.abs(rng.normal(size=(n, d))) + 0.1
    w = rng.uniform(0.5, 1.5, size=n)
    return pts, var, w / w.sum()


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("n,d", [(1, 2), (2, 1), (3, 3), (7, 2), (33, 1),
                                 (257, 3), (1000, 2), (300, 8)])
def test_twin_equals_jax_device_tree_stats(n, d, ties):
    """The twin kept beside the kernels builds the JAX package's tree (the
    float64 sums differ in order only)."""
    rng = np.random.default_rng(n * 10 + d)
    pts, var, w = _inputs(rng, n, d, ties)
    got = [t.numpy() for t in device_plan.device_tree_stats(
        *(torch.as_tensor(x) for x in (pts, var, w)))]
    want = [np.asarray(t) for t in jdp.device_tree_stats(
        *(jnp.asarray(x) for x in (pts, var, w)))]
    for g, x in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, x, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(got[3], want[3])


def test_cpu_tensors_take_the_twin(monkeypatch):
    """A plan of CPU densities takes the eager build and never the kernel
    wrapper; ``device_tree_stats`` with and without a set axis agree, and
    its moments are those of its own leaf order."""
    import kde_tpu_torch as kt

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU plan reached the kernels")

    monkeypatch.setattr(tree_build, "launch", refuse)
    rng = np.random.default_rng(5)
    sets = [[kt.kde(torch.as_tensor(rng.normal(size=(2, 50)) + j), [0.3])
             for j in range(2)] for _ in range(2)]
    got = device_plan.batched_device_plans(sets, 100, F64)
    want = device_plan._eager_arrays(sets, (50, 50), got[7], F64)
    for g, x in zip(got[:6] + got[8:], want):
        assert torch.equal(g, x)
    raw = [_inputs(rng, 50, 2) for _ in range(2)]
    stacked = [torch.stack([torch.as_tensor(s[i]) for s in raw])
               for i in range(3)]
    both = device_plan.device_tree_stats(*stacked)
    for i in range(2):
        one = device_plan.device_tree_stats(*(x[i] for x in stacked))
        for g, x in zip(one, both):
            assert torch.equal(g, x[i])
    again = device_plan._tree_moments(*stacked, both[3][:, 50:])
    for g, x in zip(again, both):
        assert torch.equal(g, x)


def test_tree_stats_refuses_what_the_kernels_do_not_take():
    """The kernel wrapper takes CUDA tensors only: CPU tensors, arrays and
    an empty plan raise before anything is built."""
    rng = np.random.default_rng(6)
    pts, var, w = (torch.as_tensor(x)[None] for x in _inputs(rng, 20, 2))
    with pytest.raises(TypeError):
        tree_build.launch([(pts.numpy(), var, w)], F64, 40)
    with pytest.raises(ValueError):
        tree_build.launch([(pts, var, w)], F64, 40)
    with pytest.raises(ValueError):
        tree_build._check([], F64)


@pytest.mark.parametrize("n,d", [(257, 2), (1000, 3), (20_000, 2)])
def test_twin_tree_is_a_median_split_on_tied_spreads(n, d):
    """On dims whose spreads tie in real arithmetic the twin's tree passes
    the median-split check the card tests hold K8's to, and the check
    finds a broken leaf order."""
    rng = np.random.default_rng(n + d)
    pts = equal_spread_points(rng, n, d)
    var = np.abs(rng.normal(size=(n, d))) + 0.1
    w = np.full(n, 1.0 / n)
    perm = device_plan.device_tree_stats(
        *(torch.as_tensor(x) for x in (pts, var, w)))[3].numpy()
    assert median_split_violations(pts, perm) == []
    broken = perm.copy()
    broken[[n, 2 * n - 1]] = broken[[2 * n - 1, n]]
    assert median_split_violations(pts, broken)


@pytest.mark.parametrize("npts,d", [((20_000, 20_000), 2), ((500,) * 3, 3),
                                    ((100_000, 5), 2)])
def test_card_workspace_from_shapes(npts, d):
    """On a CUDA device the sizing model counts K8's workspace: the order's
    two int32 buffers, the swept weights, ``t_logw`` and ``t_perm``, the
    level table, and the multi-block route's keys and split dims only
    where a density is wider than one block's shared memory (the card
    test holds it to the allocator's peak)."""
    for dtype in (F32, F64):
        item = torch.empty((), dtype=dtype).element_size()
        nodes = 7 * len(npts)
        got = device_plan.build_bytes(npts, d, item, nodes, device="cuda")
        dn, m = len(npts), max(npts)
        base = 2 * dn * m * 4 + dn * 2 * m * (2 * item + 8) + nodes * 5
        wide = max(npts) > tree_build.SUBTREE_MAX_WIDTH
        assert (got > base) == wide
        assert got == tree_build.workspace_bytes(npts, item, nodes)
        assert device_plan.build_bytes(npts, d, item, nodes) == \
            device_plan.build_bytes(npts, d, item, nodes, device="cpu")
    card = sizing.product_bytes(npts, d, 256, plan="device", device="cuda")
    cpu = sizing.product_bytes(npts, d, 256, plan="device", device="cpu")
    assert card["args"] != cpu["args"]


def test_plan_span_counts_the_kernel_launches():
    """The ``plan`` span's ``launches`` read ``tree_build.LAUNCHES``."""
    assert ("tree_build", "kde_tpu_torch.ops.tree_build",
            "LAUNCHES") in spans.COUNTERS
    before = tree_build.LAUNCHES
    try:
        with spans.recording():
            with spans.span("plan") as attrs:
                tree_build.LAUNCHES += 2
        assert attrs["launches"] == {"tree_build": 2}
    finally:
        tree_build.LAUNCHES = before
        spans.records()
