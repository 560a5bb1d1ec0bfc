"""K8's share of its roofline in the refreshing serving cell: the least
time of every traced ``refresh``'s plan (``bounds/k8.py``, from its
shapes: ``sets`` sets of ``densities`` beliefs) over the device time of
K8's kernels, by name."""

from portbench.layer_metrics_k8 import k8_share


def read(ctx):
    return k8_share(ctx.trace, ctx.work.get("k8_plans", []))
