"""Device-idle milliseconds a ``*`` request charged to the LOOCV refit: the
program's ``loocv.bracket`` and ``loocv.search`` spans. The trace's idle
intervals are cut at every span edge and each piece goes to the innermost
span open over it (``program_spans.py``); the total goes over the count of
the trace's ``product`` roots."""

from portbench.program_spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "refit")
