"""LOOCV fits completed in the window over the window's seconds."""


def read(record):
    return record["requests"] / record["window_s"]
