"""Device-idle milliseconds inside one ``refresh``: the trace's idle
intervals cut at the edges of the harness's ``portbench.refresh``
annotations, over their count (the host's plan build that the calls in
flight do not hide)."""

from portbench.harness_spans import idle_ms


def read(ctx):
    return idle_ms(ctx.trace, "refresh")
