"""Fixtures of the benchmark's tests: cells at a size the CPU holds, run
through the port's CPU twins, and the card fixture of tests marked
``cuda``.

Each cell's small size is a file of its own, ``portbench/small/<cell>.json``:
``{"traffic": {...}, "seconds": s}``, the keys of its traffic mix to change
and the seconds of a window long enough for every check to read."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL_DIR = ROOT / "portbench" / "small"
_SIZES = {p.stem: json.loads(p.read_text())
          for p in sorted(SMALL_DIR.glob("*.json"))}
# each cell's traffic at a size the CPU holds, and its window's seconds
SMALL = {name: s["traffic"] for name, s in _SIZES.items()}
SECONDS = {name: float(s["seconds"]) for name, s in _SIZES.items()}
SEED = 3_123_456_789


def run_small(name, trace=False, control=None, seed=SEED, traffic=None,
              seconds=None):
    """One run of cell ``name`` on the CPU at its small size (``traffic``
    changes more of its mix, ``seconds`` the window's length)."""
    from portbench import core
    c = core.cell(name, seed, "cpu", traffic={**SMALL[name],
                                              **(traffic or {})})
    return core.run(c, seconds or SECONDS[name], trace, time.perf_counter(),
                    control=control)


@pytest.fixture
def card():
    """Skips unless torch sees a CUDA card (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
