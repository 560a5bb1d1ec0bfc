"""Seconds from the process's start to the first timed request: imports,
the CUDA context, the inputs made from the seed, the program's set-up (a
sampler's plan) and the warm-up of the cell's own shapes, nvcc's builds in
a checkout's first run."""


def read(record):
    return record["setup_s"]
