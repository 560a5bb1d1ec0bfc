"""The least time an H100 SXM could take for a count of operations and
bytes, from the published figures in ``peaks.json``."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


def least_seconds(bytes_=0.0, **ops) -> float:
    """The larger of each unit's operations over its peak rate (``sfu``,
    ``fp32``, ``int32``, ``fp64``: per SM per clock, on every SM at the top
    clock) and of the bytes over the memory bandwidth."""
    rate = PEAKS["sms"] * PEAKS["sm_clock_hz"]
    per = PEAKS["per_sm_per_clock"]
    times = [n / (per[unit] * rate) for unit, n in ops.items()]
    return max(times + [bytes_ / PEAKS["hbm_bytes_per_s"]])
