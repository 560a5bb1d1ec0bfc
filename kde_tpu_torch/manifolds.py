"""Per-dimension manifold hooks (ports ``kde_tpu/manifolds.py``).

The reference threads pluggable per-dimension operators through every
layer: ``addop``/``diffop`` for on-manifold + and - (reference
src/KDE01.jl:10-11, src/DualTree01.jl:261-262) and, in the Gibbs product
engine, ``getMu``/``getLambda`` for the information-form Gaussian product
(src/MSGibbs01.jl:141-161).  The Euclidean operators are the defaults;
circular (S^1) operators are provided, and users pass their own (an SE(2)
pose mixes Euclidean x/y with a circular heading).  A length-1 tuple
broadcasts to all dimensions (src/MSGibbs01.jl:672-675).

The hook contract:

- every hook is a torch callable, elementwise and broadcasting, applied to
  whole tensors of one dimension's values;
- ``addop(a, b)`` and ``diffop(a, b)`` return ``a (+) b`` and ``a (-) b``;
- ``get_lambda(lambdas, axis=-1)`` and ``get_mu(mus, lambdas, scale,
  axis=-1)`` reduce over ``axis``, the density axis of one product term.
  The Gibbs engine calls them on ``[B, C, dn]`` tensors (density sets,
  chains, densities) with ``axis=-1`` and a ``[B, C]`` ``scale`` (the
  product variance ``1 / Λ``); the JAX package calls them per chain on
  ``[dn]`` vectors with ``axis=0``.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

# ---- Euclidean defaults ---------------------------------------------------


def euclid_add(a, b):
    return a + b


def euclid_diff(a, b):
    return a - b


def euclid_lambda(lambdas, axis=-1):
    """Λ = Σ_i Λ_i (reference src/MSGibbs01.jl:141)."""
    return torch.sum(lambdas, dim=axis)


def euclid_mu(mus, lambdas, scale, axis=-1):
    """μ = scale · Σ_i Λ_i μ_i (reference src/MSGibbs01.jl:152-161);
    ``scale`` is 1/Λ, so the result is the information-weighted mean."""
    return scale * torch.sum(mus * lambdas, dim=axis)


# ---- circular manifold (S^1) ----------------------------------------------


def circular_diff(a, b):
    """Angular difference wrapped to [-pi, pi] (``torch.round`` rounds
    half to even, as ``jnp.round`` does)."""
    d = a - b
    return d - 2.0 * math.pi * torch.round(d / (2.0 * math.pi))


def circular_add(a, b):
    s = a + b
    return s - 2.0 * math.pi * torch.round(s / (2.0 * math.pi))


def circular_lambda(lambdas, axis=-1):
    """The information sum does not depend on the manifold."""
    return torch.sum(lambdas, dim=axis)


def circular_mu(mus, lambdas, scale, axis=-1):
    """Information-weighted mean of angles, with differences taken from
    the highest-information component so the average stays on the right
    side of the wrap.  The anchor must contribute: during a leave-one-out
    sweep the skipped density carries lambda = 0, and anchoring at it could
    wrap the live differences to opposite signs.  ``torch.argmax`` returns
    the first maximum, as ``jnp.argmax`` does."""
    anchor = torch.argmax(lambdas, dim=axis, keepdim=True)
    ref = torch.gather(mus, axis, anchor)
    d = circular_diff(mus, ref)
    return circular_add(ref.squeeze(axis),
                        scale * torch.sum(d * lambdas, dim=axis))


# ---- tuple broadcasting ---------------------------------------------------


def broadcast_ops(ops, ndim: int) -> Tuple[Callable, ...]:
    """Broadcast a length-1 op tuple to ``ndim`` dims; any other length
    mismatch raises (reference idiom at src/KDE01.jl:10-11)."""
    if ops is None:
        return None
    ops = tuple(ops) if isinstance(ops, (tuple, list)) else (ops,)
    if len(ops) == ndim:
        return ops
    if len(ops) != 1:
        raise ValueError(
            f"manifold op tuple has {len(ops)} entries for {ndim} "
            "dimensions; pass one per dimension or a length-1 tuple to "
            "broadcast")
    return ops * ndim


def is_euclidean(ops, default) -> bool:
    """True if every per-dim op is the Euclidean default."""
    return ops is None or all(op is default for op in ops)


# each hook's name and its Euclidean default
HOOK_DEFAULTS = (("addop", euclid_add), ("diffop", euclid_diff),
                 ("get_mu", euclid_mu), ("get_lambda", euclid_lambda))
