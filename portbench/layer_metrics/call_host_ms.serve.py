"""Host milliseconds from entering ``BatchedProductSampler.sample`` to its
return, with no synchronise: the benchmark's own span, the mean over the
traced window's calls."""


def read(ctx):
    calls = ctx.spans.get("call_host", [])
    return 1e3 * sum(calls) / len(calls) if calls else None
