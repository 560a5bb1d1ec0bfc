"""Random-generator management (ports ``kde_tpu/utils/random.py``).

Every stochastic function takes an explicit ``key``: a ``torch.Generator``
passes through, a plain int seeds a fresh generator on the target device,
and ``None`` draws from the module generator of that device, seeded by
:func:`set_seed` (the reference uses Julia's global RNG).  Torch and JAX
give different numbers for the same seed; tests that compare the two
packages inject numpy streams instead (replay mode).
"""

from __future__ import annotations

from typing import List

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


def split(key, n: int, device="cpu") -> List[int]:
    """``n`` int seeds derived deterministically from ``key`` (the
    counterpart of ``jax.random.split`` as ``_gibbs_batched_sets`` uses it,
    ``kde_tpu/ops/gibbs.py:985``): set ``i`` of a batched draw draws from
    ``make_generator(split(key, B)[i])``, so it equals a standalone draw
    keyed with that seed.  An int key derives the seeds on the host
    (NumPy's ``SeedSequence``); a ``torch.Generator``, or ``None`` for the
    module generator of ``device``, gives them in one draw from it."""
    if isinstance(key, (int, np.integer)):
        state = np.random.SeedSequence(int(key) & ((1 << 64) - 1)) \
            .generate_state(n, dtype=np.uint64)
        return [int(s) >> 1 for s in state]
    g = make_generator(key, device)
    return torch.randint(0, 1 << 62, (n,), generator=g,
                         device=g.device).tolist()


# ---------------------------------------------------------------------------
# counter-based uniforms: the twin of csrc/counter_rng.cuh
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_CHUNK = 1 << 25          # Threefry blocks of counter_uniform at a time
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds, the block function of JAX's
    ``threefry_2x32`` (``jax._src.prng``): the block of counter ``(x0,
    x1)`` under key ``(k0, k1)``.  Words are 32-bit values held in Python
    ints or int64 tensors (broadcast together), so integer adds, rotates
    and xors masked to 32 bits give the kernels' bits on any device."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(k0, k1, x):
    """The key ``(k0, k1)`` with the word ``x`` folded in, as
    ``jax.random.fold_in`` folds it: the block of counter ``(0, x)``."""
    return threefry2x32(k0, k1, x * 0, x)


def counter_seed(gen: torch.Generator) -> torch.Tensor:
    """A set's seed for the counter draws: two 32-bit words from ``gen``,
    as an int64 ``[2]`` tensor on the generator's device."""
    return torch.randint(0, 1 << 32, (2,), generator=gen, dtype=torch.int64,
                         device=gen.device)


def counter_uniform(seeds: torch.Tensor, chains: torch.Tensor,
                    sels: torch.Tensor, w: int, dtype) -> torch.Tensor:
    """The Gumbel draws' uniforms ``[B, C, S, w]`` of candidates ``0..w-1``
    for chains ``chains [C]`` (global indices) and selection ids ``sels
    [S]`` of ``B`` sets with seeds ``seeds [B, 2]`` (int64 tensors on one
    device), in ``dtype``; csrc/counter_rng.cuh step for step: the key
    ``fold_in(fold_in(seed, chain), sel)``, the block at counter ``(2q,
    2q + 1)`` giving float32 candidates ``2q, 2q + 1`` a word each or
    float64 candidate ``q`` both, the word-to-float map under the exponent
    of 1, then the clamp to ``[tiny, 1 - eps]``."""
    k0, k1 = fold_in(seeds[:, 0, None, None], seeds[:, 1, None, None],
                     chains[None, :, None])
    k0, k1 = fold_in(k0, k1, sels[None, None, :])                 # [B, C, S]
    one = dtype == torch.float32
    q = torch.arange((w + 1) // 2 if one else w, device=seeds.device)
    out = torch.empty(k0.shape + (w,), dtype=dtype, device=seeds.device)
    # chains in chunks of about _CHUNK blocks: the int64 words of a block
    # take 16 bytes and their arithmetic a few times that
    step = max(1, _CHUNK // max(1, k0.shape[0] * k0.shape[2] * q.numel()))
    for c0 in range(0, k0.shape[1], step):
        y0, y1 = threefry2x32(k0[:, c0:c0 + step, :, None],
                              k1[:, c0:c0 + step, :, None], 2 * q, 2 * q + 1)
        if one:
            words = torch.stack((y0, y1), dim=-1).flatten(-2)[..., :w]
            u = ((words >> 9) | 0x3F800000).to(torch.int32).view(dtype)
        else:
            u = ((y0 << 20) | (y1 >> 12) | 0x3FF0000000000000).view(dtype)
        out[:, c0:c0 + step] = u - 1.0
    fi = torch.finfo(dtype)
    return out.clamp_(fi.tiny, 1.0 - fi.eps)
