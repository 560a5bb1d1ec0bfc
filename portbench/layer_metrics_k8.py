"""K8's share of its roofline, as its per-layer readers take it: the least
time of the plans built in the traced window (``bounds/k8.py``, from their
shapes) over the device time of K8's kernels (``csrc/tree_build.cu``), by
the substrings of their names in the profiler's trace."""

from __future__ import annotations

from portbench.bounds import k8

KERNELS = ("multi_sort_kernel", "multi_stats_kernel", "multi_rank_kernel",
           "subtree_kernel", "top_kernel", "levels_kernel")


def k8_share(trace, plans):
    """``plans``: one dict a plan built (``sets``, ``npts``, ``d``,
    ``n_out``, ``itemsize``); None where K8 ran no kernel."""
    device_s = trace.kernel_seconds(*KERNELS)
    if device_s <= 0.0 or not plans:
        return None
    bound = sum(k8.plan_seconds(**p) for p in plans)
    return 100.0 * bound / device_s
