"""Kernel launches a ``*`` request makes while building its device plan:
the runtime's launch calls (``cudaLaunch*``, ``cuLaunch*``) on the
window's thread inside the trace's ``kde_tpu_torch.plan`` annotations,
over its ``product`` roots: the count of the plan's eager kernels."""

from portbench.program_spans import launches


def read(ctx):
    return launches(ctx, "plan")
