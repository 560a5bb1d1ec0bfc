"""K3's share of its roofline in the refreshing serving cell: the least
time of every traced ``sample`` call's Gibbs chains (``bounds/k3.py``, from
the call's shapes) over the device time of K3's kernels, by name."""

from portbench.layer_metrics_common import k3_share


def read(ctx):
    return k3_share(ctx)
