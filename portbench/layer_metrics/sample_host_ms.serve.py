"""Host milliseconds from entering ``BatchedProductSampler.sample`` to its
return, with no synchronise, by the program's own ``sample`` span: the
mean over the traced window's calls (the twin from inside of the
harness's ``call_host_ms.serve``)."""

from portbench.program_spans import host_ms


def read(ctx):
    return host_ms(ctx, "sample", "sample")
