"""``parallel/sizing.py::estimate_product_memory`` sizes the level plan
from shapes: the same dict as the plan it would build, and nothing built,
cached or allocated (the plan cache stays empty).  Each term of the model
is held to what the product holds, and the whole estimate to the live
bytes of CPU runs of the device build and of the chain route."""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

from kde_tpu_torch import kde  # noqa: E402
from kde_tpu_torch import prod_appx_ms_gibbs as kde_prod  # noqa: E402
from kde_tpu_torch.ops import device_plan  # noqa: E402
from kde_tpu_torch.ops import gibbs as g  # noqa: E402
from kde_tpu_torch.ops.device_plan import build_bytes  # noqa: E402
from kde_tpu_torch.parallel import sizing  # noqa: E402


def _built_estimate(densities, n_out, n_iter, dtype, select):
    """The estimate as it was computed from a built plan."""
    device = densities[0].device
    impl = g._resolve_plan_impl(densities, "auto", replay=False)
    plan = g._get_plan(densities, n_out, dtype, device, impl)
    dn, d = plan.ndens, plan.ndim
    sel = g.resolve_select(select, n_out, plan.offsets[-1][1])
    item = torch.empty((), dtype=dtype).element_size()
    args = (sum(getattr(plan, f).nbytes for f in g._PLAN_TENSORS)
            + plan.lvl_uniform.nbytes + dn * d)
    if impl == "device":
        args += build_bytes([p.npts for p in densities], d, item,
                            plan.lvl_mean.shape[0] * plan.lvl_mean.shape[1])
    bu, bn = g._stream_sizes(dn, d, plan.n_levels, n_iter)
    # gumbel: the normals and the counter seed (two int64 words)
    streams = (n_out * bn * item + 16 if sel == "gumbel"
               else n_out * (bu + bn) * item)
    hooks = g.normalize_hooks(*g._density_hooks(densities), d)
    route = g._route(sel, hooks, device, dn, d)
    live = g._live_temps(route)
    block = g._chain_block(n_out, plan, item, live)
    out = n_out * (d * item + plan.n_levels * dn * 8)
    temp = (2 * streams + live * max(w for _, w in plan.offsets) * item * block
            + (0 if route == "chain" else 2 * out))
    return {"args": int(args), "temp": int(temp), "out": int(out),
            "total": int(args + temp + out), "select": sel}


@pytest.mark.parametrize("plan", ["host", "device"])
@pytest.mark.parametrize("dn,d", [(2, 1), (2, 2), (3, 3), (3, 1)])
def test_estimate_sizes_the_plan_from_shapes(plan, dn, d):
    rng = np.random.default_rng(dn * 10 + d)
    dens = []
    for j in range(dn):
        pts = rng.normal(size=(d, 40 + 17 * j))
        if plan == "device":
            dens.append(kde(torch.as_tensor(pts), [0.3] * d))
        else:
            dens.append(kde(pts, [0.3] * d))
    assert g._resolve_plan_impl(dens, "auto", replay=False) == plan
    for n_out, dtype, select in ((64, torch.float32, "auto"),
                                 (300, torch.float64, "gumbel"),
                                 (100, torch.float32, "blocked")):
        g._plan_cache.clear()
        got = sizing.estimate_product_memory(dens, n_out, n_iter=3,
                                             dtype=dtype, select=select)
        assert not g._plan_cache
        assert got == _built_estimate(dens, n_out, 3, dtype, select)
    g._plan_cache.clear()


# ---------------------------------------------------------------------------
# each term of the model, and the model against the live bytes of a CPU run
# ---------------------------------------------------------------------------

def _dens(ns, d=2, seed=0, device_resident=True):
    rng = np.random.default_rng(seed)
    pts = [rng.normal(size=(d, n)) for n in ns]
    if device_resident:
        return [kde(torch.as_tensor(x, dtype=torch.float32), [0.1])
                for x in pts]
    return [kde(x, [0.1], dtype=torch.float32) for x in pts]


def test_streams_count_twice_on_the_chain_route(monkeypatch):
    """``_gibbs_keyed`` keeps each set's draws and their stacked copy."""
    dens = _dens((300, 200))
    monkeypatch.setattr(g, "_route", lambda *a: "chain")
    est = sizing.estimate_product_memory(dens, 500, n_iter=4)
    L = g._n_levels(500, [300, 200])
    bu, bn = g._stream_sizes(2, 2, L, 4)
    assert est["temp"] == 2 * 500 * (bu + bn) * 4


def test_out_counts_the_per_level_labels():
    """The returned labels are a view of the per-level labels, which the
    model counts whole: ``out`` equals the bytes of the points and the
    recorded per-level labels of the same product."""
    dens = _dens((300, 200), device_resident=False)
    est = sizing.estimate_product_memory(dens, 128, n_iter=2)
    pts, _, labels = kde_prod(128, dens, n_iter=2, key=0, record_labels=True)
    assert labels.dtype == torch.int64
    assert est["out"] == pts.nbytes + labels.nbytes


def test_args_count_the_uniform_level_flags():
    """The plan's ``lvl_uniform`` flags count in ``args``."""
    dens = _dens((300, 200), device_resident=False)
    est = sizing.estimate_product_memory(dens, 64, n_iter=2)
    plan = g._get_plan(dens, 64, torch.float32, torch.device("cpu"), "host")
    tensors = sum(getattr(plan, f).nbytes for f in g._PLAN_TENSORS)
    assert plan.lvl_uniform.nbytes > 0
    assert est["args"] == tensors + plan.lvl_uniform.nbytes + 2 * 2
    g._plan_cache.clear()


def test_off_the_chain_route_the_output_copies_count(monkeypatch):
    """Off the chain route the per-level label clones and the blocks'
    concatenation add two copies of the outputs to ``temp``."""
    dens = _dens((300, 200))
    monkeypatch.setattr(g, "_route", lambda *a: "chain")
    chain = sizing.estimate_product_memory(dens, 100, n_iter=2)
    monkeypatch.setattr(g, "_route", lambda *a: "twin")
    twin = sizing.estimate_product_memory(dens, 100, n_iter=2)
    widest = 300
    block = g._chains_per_block(100, widest, 4, g._LIVE_TEMPS)
    assert twin["temp"] - chain["temp"] == (g._LIVE_TEMPS * widest * 4 * block
                                            + 2 * chain["out"])


@pytest.mark.parametrize("ns", [range(1, 70), (255, 256, 257, 1000),
                                (4097, 20_000, 50_001)])
def test_topology_and_level_widths_from_slice_sizes(ns):
    """``topology_bytes`` and ``level_widths``, counted from the slice
    sizes, equal the arrays ``_topology`` builds and the level lists'
    lengths, so the model needs neither (and sizes any N)."""
    for n in ns:
        t = device_plan._topology(n)
        slices = [pd for pd in t["per_depth"] if pd is not None]
        want = (sum(v.nbytes for pd in slices for v in pd.values())
                + sum(a.nbytes for m in t["merges"] for a in m),
                max(pd["idx"].size for pd in slices) if slices else n)
        assert device_plan.topology_bytes(n) == want, n
        L = n.bit_length() + 1
        assert device_plan.level_widths(n, L) == [
            len(x) for x in device_plan._level_nodes(n, L)[1:]], n


def _live_peak(fn):
    """Peak of the bytes held by live CPU tensors while ``fn()`` runs, from
    the profiler's allocation records, at op granularity.  The port's span
    annotations (utils/spans.py) stay out of the profile: an annotation
    would own every allocation and free made between the ops inside it,
    all counted at its start."""
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile

    from kde_tpu_torch.utils import spans
    with mock.patch.object(spans, "record_function", contextlib.nullcontext), \
            profile(activities=[ProfilerActivity.CPU],
                    profile_memory=True) as p:
        fn()
    spans.records()
    live = peak = 0
    for e in sorted(p.profiler.function_events,
                    key=lambda e: e.time_range.start):
        live += e.self_cpu_memory_usage
        peak = max(peak, live)
    return peak


@pytest.fixture
def uploaded_topology(monkeypatch):
    """The topology index tensors as a card holds them: copies (on the CPU
    ``torch.as_tensor`` would share NumPy's memory and allocate nothing)."""
    import functools

    @functools.lru_cache(maxsize=None)
    def on(n, device):
        topo = device_plan._topology(n)
        up = lambda x: torch.as_tensor(x, device=device).clone()
        return ([None if pd is None else {k: up(v) for k, v in pd.items()}
                 for pd in topo["per_depth"]],
                [tuple(up(a) for a in m) for m in topo["merges"]])
    monkeypatch.setattr(device_plan, "_topology_on", on)


@pytest.mark.parametrize("ns", [(3000, 3000), (5000, 2000), (1, 700)])
def test_build_bytes_cover_the_device_builds_live_peak(ns,
                                                       uploaded_topology):
    """The device build's live bytes stay within its plan's tensors and
    ``build_bytes`` (topology, tree-statistics workspace, assembly)."""
    dens = _dens(ns)
    held = []
    peak = _live_peak(lambda: held.append(device_plan.DeviceProductPlan(
        dens, 256, torch.float32)))
    plan = held[0]
    own = (sum(getattr(plan, f).nbytes for f in g._PLAN_TENSORS)
           + plan.lvl_uniform.nbytes)
    est = own + device_plan.build_bytes(ns, 2, 4, plan.lvl_logw.numel())
    assert peak <= est <= 2 * peak


@pytest.mark.parametrize("ns,n_out", [((4000, 4000), 4000),
                                      ((6000, 6000), 256),
                                      ((3000, 1000), 1000)])
def test_estimate_covers_the_chain_routes_live_peak(ns, n_out, monkeypatch,
                                                    uploaded_topology):
    """A keyed product of device-resident densities on the chain route,
    the kernel launch replaced by the allocations of its wrapper
    (``gibbs_chain._launch``: points and per-level labels), holds no more
    live bytes than the estimate, and at least half."""
    from kde_tpu_torch.ops import gibbs_chain as gc

    def launch(u, nrm, plans, mask, n_iter, add_entropy, codes, *_):
        b, dn, _, d = plans.lvl_mean.shape
        c, L = nrm.shape[1], plans.n_levels
        out_x = torch.zeros((b, c, d), dtype=plans.lvl_mean.dtype)
        out_lv = torch.zeros((b, c, L, dn), dtype=torch.int64)
        return out_x, out_lv[:, :, L - 1], out_lv
    monkeypatch.setattr(g, "_route", lambda *a: "chain")
    monkeypatch.setattr(gc, "gibbs_chain", launch)
    dens = _dens(ns)
    peak = _live_peak(lambda: kde_prod(n_out, dens, n_iter=5, key=0))
    est = sizing.estimate_product_memory(dens, n_out, n_iter=5)
    assert peak <= est["total"] <= 2 * peak
    g._plan_cache.clear()
