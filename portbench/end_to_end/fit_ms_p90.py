"""The 90th percentile of every LOOCV fit's latency in the window
(linear interpolation between order statistics)."""

import numpy as np


def read(record):
    lat = record["latency_ms"]
    return float(np.percentile(lat, 90)) if lat else None
