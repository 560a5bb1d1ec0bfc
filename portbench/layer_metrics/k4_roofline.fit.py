"""K4's share of its roofline in the fit cell: the least time of every
traced fit's golden searches (``bounds/k4.py``, with the probes the
reference's own search makes over the same points) over the device time of
K4's kernels, by name."""

from portbench.layer_metrics_common import k4_share


def read(ctx):
    return k4_share(ctx)
