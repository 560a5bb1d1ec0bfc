"""The least time of the LOOCV golden searches of one fit (K4's work),
counted from the points and the probes the reference's own search makes.

Every live pair (i != j, both weights positive) once for the
nearest-neighbour shifts and once per probe of its row.  float32: one ex2 a
probe pair on the SFU, or 4 FP32 instructions a probe pair and 3 a shift
pair (difference, square, min), whichever is longer.  Bytes: rows, weights
and brackets read once, the result written once."""

from __future__ import annotations

from .roofline import least_seconds


def search_seconds(n: int, probes, itemsize: int = 4) -> float:
    rows = len(probes)
    pairs = n * (n - 1)
    probe_pairs = pairs * sum(probes)
    shift_pairs = pairs * rows
    nbytes = itemsize * (rows * n + n + 5 * rows)
    return least_seconds(nbytes, sfu=probe_pairs,
                         fp32=4 * probe_pairs + 3 * shift_pairs)
