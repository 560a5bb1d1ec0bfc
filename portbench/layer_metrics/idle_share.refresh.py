"""The device's idle share over the traced window: 1 - busy / window, the
busy time the union of the kernels', copies' and sets' intervals."""


def read(ctx):
    return 100.0 * ctx.trace.idle_share()
