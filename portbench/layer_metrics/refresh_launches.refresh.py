"""Kernel launches one ``refresh`` makes: the runtime's launch calls
(``cudaLaunch*``, ``cuLaunch*``) on the window's thread inside the
harness's ``portbench.refresh`` annotations, over their count."""

from portbench.harness_spans import launches


def read(ctx):
    return launches(ctx.trace, "refresh")
