"""Host milliseconds of one ``BatchedProductSampler.refresh`` call with new
messages, its plan's build among them (K8 on the card): the harness's own
timer around the call, the mean over the traced window's refreshes."""


def read(ctx):
    calls = ctx.spans.get("refresh", [])
    return 1e3 * sum(calls) / len(calls) if calls else None
