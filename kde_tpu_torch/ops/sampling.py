"""Sampling and resampling from a KDE (ports ``kde_tpu/ops/sampling.py``).

Reference semantics (src/KDE01.jl:155-198, src/BallTreeDensity01.jl:312-334):
draw kernel indices from the weight CDF with sorted uniforms, then jitter by
the per-kernel bandwidth.  The reference's sorted-uniform merge scan is
``searchsorted(cdf, u, right=True)`` over sorted uniforms.  Each function
draws from ``utils.random.make_generator(key, p.device)``: uniforms first,
then normals, on the density's device, so the draws differ from the JAX
package's for the same seed (its ``sample`` splits one key in two).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..density import KDE, kde
from ..utils.random import make_generator


def draw_indices(weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Kernel indices for uniforms ``u``: the first index whose normalized
    weight CDF exceeds ``u`` (``searchsorted(..., right=True)``), clipped
    to the last kernel.  The CDF is accumulated in float64: on CUDA the
    summation order of ``torch.cumsum`` depends on the tensor's shape."""
    cdf = torch.cumsum(weights.to(torch.float64), dim=0)
    cdf = cdf / cdf[-1]
    ind = torch.searchsorted(cdf, u.to(torch.float64), right=True)
    return ind.clamp(0, weights.shape[0] - 1)


def _sorted_uniforms(p: KDE, n: int, gen) -> torch.Tensor:
    return torch.rand(n, generator=gen, dtype=p.dtype,
                      device=p.device).sort().values


def sample(p: KDE, n: int, key=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw ``n`` points; returns ``(points [d, n], kernel_indices [n])``
    with 0-based indices (reference src/KDE01.jl:164-183)."""
    gen = make_generator(key, p.device)
    ind = draw_indices(p.weights, _sorted_uniforms(p, n, gen))
    noise = torch.randn((n, p.ndim), generator=gen, dtype=p.dtype,
                        device=p.device)
    return (p.points[ind] + torch.sqrt(p.bw[ind]) * noise).T, ind


def sample_at(p: KDE, ind, key=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample with fixed kernel labels ``ind`` (reference
    src/KDE01.jl:185-189)."""
    gen = make_generator(key, p.device)
    ind = torch.as_tensor(ind, device=p.device)
    noise = torch.randn((ind.shape[0], p.ndim), generator=gen,
                        dtype=p.dtype, device=p.device)
    return (p.points[ind] + torch.sqrt(p.bw[ind]) * noise).T, ind


def rand_kde(p: KDE, n: int = 1, key=None) -> torch.Tensor:
    """Points only (reference ``rand``, src/KDE01.jl:196-198)."""
    return sample(p, n, key)[0]


def resample(p: KDE, n: Optional[int] = None, ks_type: str = "lcv",
             key=None) -> KDE:
    """A new KDE from ``n`` fresh samples of ``p`` (reference
    src/BallTreeDensity01.jl:312-334), on ``p``'s device, in its dtype and
    with its manifold hooks.

    ``lcv``: jittered samples, bandwidths refit by LOOCV.  ``discrete``:
    kernel centers drawn by weight without jitter, keeping their
    bandwidths.  The jitter is Euclidean, as the reference's randKernel
    (src/KDE01.jl:155-157, no addop)."""
    if n is None:
        n = p.npts
    if ks_type not in ("lcv", "discrete"):
        raise ValueError(
            f"unknown ks_type {ks_type!r}: expected 'lcv' or 'discrete' "
            "(reference resample, src/BallTreeDensity01.jl:312-334)")
    if ks_type == "lcv":
        pts, _ = sample(p, n, key)
        return kde(pts, **p._hooks)
    ind = draw_indices(p.weights, _sorted_uniforms(
        p, n, make_generator(key, p.device)))
    ks = torch.sqrt(p.bw[ind]).T if p.multibandwidth else torch.sqrt(p.bw[0])
    return kde(p.points[ind].T, ks, **p._hooks)
