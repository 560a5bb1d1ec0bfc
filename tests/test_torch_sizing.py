"""``parallel/sizing.py::estimate_product_memory`` sizes the level plan
from shapes: the same dict as the plan it would build, and nothing built,
cached or allocated (the plan cache stays empty)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

from kde_tpu_torch import kde  # noqa: E402
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
    args = sum(getattr(plan, f).nbytes for f in g._PLAN_TENSORS) + dn * d
    if impl == "device":
        args += build_bytes([p.npts for p in densities], d)
    bu, bn = g._stream_sizes(dn, d, plan.n_levels, n_iter)
    streams = n_out * ((0 if sel == "gumbel" else bu) + bn) * item
    hooks = g.normalize_hooks(*g._density_hooks(densities), d)
    live = g._live_temps(g._route(sel, hooks, device, dn, d), sel, dn)
    block = g._chain_block(n_out, plan, item, live)
    temp = streams + live * max(w for _, w in plan.offsets) * item * block
    out = n_out * (d * item + dn * 8)
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
