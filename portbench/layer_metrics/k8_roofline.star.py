"""K8's share of its roofline in the star cells: the least time of the
plan every traced ``*`` request builds (``bounds/k8.py``: one set of
``densities`` beliefs of ``components`` points, as many draws) over the
device time of K8's kernels, by name."""

from portbench.layer_metrics_k8 import k8_share


def read(ctx):
    c = ctx.cell
    n = int(c.traffic["components"])
    plan = dict(sets=1, npts=[n] * int(c.traffic["densities"]),
                d=len(c.config["dims"]), n_out=n, itemsize=c.dtype.itemsize)
    return k8_share(ctx.trace, [plan] * int(ctx.record["requests"]))
