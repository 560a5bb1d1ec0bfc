"""What the per-layer readers of kernel rooflines share: the kernels' names
and the share of the bound in their device time."""

from __future__ import annotations

from portbench.bounds import k3, k4

# K3's kernels (csrc/gibbs_chain.cu) and K4's (csrc/loo_search.cu), by the
# substrings of their names in the profiler's trace
K3_KERNELS = ("gibbs_chain",)
K4_KERNELS = ("loo_search_kernel", "loo_rows_kernel")


def _share(bound_s, device_s):
    if device_s <= 0.0:
        return None
    return 100.0 * bound_s / device_s


def k3_share(ctx):
    calls = ctx.work.get("k3_calls", [])
    bound = sum(k3.chain_seconds(c["sets"], c["npts"], c["d"], c["n_out"],
                                 c["n_iter"], c["itemsize"]) for c in calls)
    return _share(bound, ctx.trace.kernel_seconds(*K3_KERNELS))


def k4_share(ctx):
    w = ctx.work
    probes = ctx.facts.get("probes", {})
    bound = sum(k4.search_seconds(w["n"], probes[k], w["itemsize"])
                for k in w.get("k4_fits", []))
    return _share(bound, ctx.trace.kernel_seconds(*K4_KERNELS))
