"""Per-dimension manifold hooks, Euclidean part (ports
``kde_tpu/manifolds.py:24-41, 82-104``).

The port runs Euclidean products only.  Non-Euclidean hooks (circular,
SE(2)) are ROADMAP item M8: :func:`require_euclidean` raises for them.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def euclid_add(a, b):
    return a + b


def euclid_diff(a, b):
    return a - b


def euclid_lambda(lambdas, axis=-1):
    """Λ = Σ_i Λ_i (reference src/MSGibbs01.jl:141)."""
    return torch.sum(lambdas, dim=axis)


def euclid_mu(mus, lambdas, scale, axis=-1):
    """μ = scale · Σ_i Λ_i μ_i (reference src/MSGibbs01.jl:152-161)."""
    return scale * torch.sum(mus * lambdas, dim=axis)


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


def require_euclidean(addop, diffop, get_mu, get_lambda, ndim: int) -> None:
    """Raise ``NotImplementedError`` for any non-Euclidean hook."""
    specs = ((addop, euclid_add), (diffop, euclid_diff),
             (get_mu, euclid_mu), (get_lambda, euclid_lambda))
    for ops, default in specs:
        if not is_euclidean(broadcast_ops(ops, ndim), default):
            raise NotImplementedError(
                "non-Euclidean manifold hooks are not ported yet "
                "(ROADMAP M8); kde_tpu_torch runs Euclidean products only")
