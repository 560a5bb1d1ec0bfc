"""Random-generator management (ports ``kde_tpu/utils/random.py``).

Every stochastic function takes an explicit ``key``: a ``torch.Generator``
passes through, a plain int seeds a fresh generator on the target device,
and ``None`` draws from the module generator of that device, seeded by
:func:`set_seed` (the reference uses Julia's global RNG).  Torch and JAX
give different numbers for the same seed; tests that compare the two
packages inject numpy streams instead (replay mode).
"""

from __future__ import annotations

import numpy as np
import torch

_state = {"seed": 0, "gens": {}}


def set_seed(seed: int) -> None:
    """Reseed the module generators (created lazily, one per device)."""
    _state["seed"] = int(seed)
    _state["gens"].clear()


def _canonical(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_generator(key=None, device="cpu") -> torch.Generator:
    """The generator a draw on ``device`` uses for ``key``."""
    if isinstance(key, torch.Generator):
        return key
    device = _canonical(device)
    if isinstance(key, (int, np.integer)):
        g = torch.Generator(device=device)
        g.manual_seed(int(key))
        return g
    if key is not None:
        raise TypeError(f"key must be None, an int or a torch.Generator, "
                        f"got {type(key).__name__}")
    g = _state["gens"].get(str(device))
    if g is None:
        g = torch.Generator(device=device)
        g.manual_seed(_state["seed"])
        _state["gens"][str(device)] = g
    return g
