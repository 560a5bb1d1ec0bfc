"""Fixtures of the benchmark's tests: cells at a size the CPU holds, run
through the port's CPU twins, and the card fixture of tests marked
``cuda``."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell's traffic at a size the CPU holds
SMALL = {
    "serve_point2_b6x1k": {"sets": 2, "components": 20, "n_out": 200,
                           "checked_calls": 3, "mean_every": 2},
    "star_pose2_2x20k": {"components": 200, "inputs": 3,
                         "checked_requests": 2},
    "star_point2_2x20k": {"components": 200, "inputs": 3,
                          "checked_requests": 2},
    "fit_point2_100k": {"components": 400, "inputs": 2},
}
SEED = 3_123_456_789


# seconds of a small window: enough calls for every check to read
SECONDS = {"serve_point2_b6x1k": 2.0}


def run_small(name, trace=False, control=None, seed=SEED):
    """One run of cell ``name`` on the CPU at its small size."""
    from portbench import core
    seconds = SECONDS.get(name, 0.6)
    c = core.cell(name, seed, "cpu", traffic=SMALL[name])
    return core.run(c, seconds, trace, time.perf_counter(), control=control)


@pytest.fixture
def card():
    """Skips unless torch sees a CUDA card (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
