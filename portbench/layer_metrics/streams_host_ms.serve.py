"""Host milliseconds a ``sample`` call spends drawing its keyed streams:
the program's ``streams`` spans (``ops/gibbs.py::_gibbs_keyed``) over its
``sample`` roots, from the program's records."""

from portbench.program_spans import host_ms


def read(ctx):
    return host_ms(ctx, "streams", "sample")
