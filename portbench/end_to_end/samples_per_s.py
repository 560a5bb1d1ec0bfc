"""Product samples completed in the window over the window's seconds."""


def read(record):
    return record["samples"] / record["window_s"]
