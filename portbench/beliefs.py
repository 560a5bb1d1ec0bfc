"""The inputs of every cell, made on the device from the run's seed.

A belief is a mixture of Gaussian modes sampled into points, as a particle
belief of nonparametric belief propagation is.  Beliefs come in groups that
describe one variable (the messages of one product, the densities of one
set): a group shares its mode centres and each belief jitters them, so the
beliefs of a product overlap as messages about one variable do.  All draws
come from one ``torch.Generator`` on the device, in a few large calls.
Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def generator(seed: int, device) -> torch.Generator:
    """The run's generator on ``device``, seeded with ``seed`` (any whole
    number; taken modulo 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def derived(seed: int, i: int) -> int:
    """The ``i``-th key derived from ``seed``: a whole number below 2**62,
    the same for the same pair."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (i + 1) * 0xBF58476D1CE4E5B9)
    x &= (1 << 64) - 1
    x ^= x >> 31
    x = (x * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (x ^ (x >> 29)) >> 2


def kinds(config) -> list:
    """Each dim's hook kind, ``euclid`` or ``circular``."""
    return [dim["hook"] for dim in config["dims"]]


def wrap(x: torch.Tensor) -> torch.Tensor:
    """Angles to (-pi, pi]."""
    return math.pi - torch.remainder(math.pi - x, TWO_PI)


def make(g: torch.Generator, groups: int, per_group: int, n: int, config,
         dtype, device) -> torch.Tensor:
    """``[groups, per_group, n, d]`` points: ``groups`` groups of
    ``per_group`` beliefs of ``n`` points each, drawn as the configuration's
    ``beliefs`` and ``dims`` say."""
    dims = config["dims"]
    d = len(dims)
    lo_m, hi_m = config["beliefs"]["modes"]
    jitter = float(config["beliefs"]["jitter"])
    m = hi_m
    f64 = dict(dtype=torch.float64, device=device)
    lo = torch.tensor([dim["center"][0] for dim in dims], **f64)
    hi = torch.tensor([dim["center"][1] for dim in dims], **f64)
    sd_lo = torch.tensor([dim["mode_sd"][0] for dim in dims], **f64)
    sd_hi = torch.tensor([dim["mode_sd"][1] for dim in dims], **f64)
    circ = torch.tensor([dim["hook"] == "circular" for dim in dims],
                        device=device)
    centres = lo + (hi - lo) * torch.rand((groups, 1, m, d), generator=g,
                                          **f64)
    centres = centres + jitter * torch.randn((groups, per_group, m, d),
                                             generator=g, **f64)
    sds = sd_lo + (sd_hi - sd_lo) * torch.rand((groups, per_group, m, d),
                                               generator=g, **f64)
    count = torch.randint(lo_m, hi_m + 1, (groups, per_group, 1),
                          generator=g, device=device)
    weights = (0.5 + torch.rand((groups, per_group, m), generator=g, **f64)
               ) * (torch.arange(m, device=device) < count)
    mode = torch.multinomial(weights.reshape(-1, m), n, replacement=True,
                             generator=g).reshape(groups, per_group, n)
    at = mode[..., None].expand(-1, -1, -1, d)
    pts = (centres.gather(2, at) + sds.gather(2, at)
           * torch.randn((groups, per_group, n, d), generator=g, **f64))
    pts = torch.where(circ, wrap(pts), pts)
    return pts.to(dtype)


def spread(pts: torch.Tensor, config) -> torch.Tensor:
    """``[..., d]`` spread of ``pts [..., n, d]`` per dim: the standard
    deviation, and on a circular dim the circular one, sqrt(-2 ln R)."""
    x = pts.double()
    sd = x.std(dim=-2)
    circ = torch.tensor([k == "circular" for k in kinds(config)],
                        device=pts.device)
    r = torch.sqrt(torch.cos(x).mean(-2) ** 2 + torch.sin(x).mean(-2) ** 2)
    csd = torch.sqrt(-2.0 * torch.log(r.clamp(1e-12, 1.0)))
    return torch.where(circ, csd, sd)


def silverman(pts: torch.Tensor, config) -> torch.Tensor:
    """``[..., d]`` bandwidths (standard deviations) of ``pts [..., n, d]``
    by Silverman's rule per dim: sd * (4 / ((d + 2) n))^(1 / (d + 4))."""
    n, d = pts.shape[-2:]
    factor = (4.0 / ((d + 2) * n)) ** (1.0 / (d + 4))
    return (spread(pts, config) * factor).to(pts.dtype)
