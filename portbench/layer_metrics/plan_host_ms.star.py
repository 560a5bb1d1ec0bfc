"""Host milliseconds a ``*`` request spends building its device plan: the
program's ``plan`` spans (``ops/gibbs.py::_get_plan``) over its
``product`` roots, from the program's records."""

from portbench.program_spans import host_ms


def read(ctx):
    return host_ms(ctx, "plan", "product")
