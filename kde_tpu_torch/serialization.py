"""Serialization: reference-compatible strings and array checkpoints
(ports ``kde_tpu/serialization.py``).

String format (reference src/StringSerialization.jl:1-26):
``KDE:<N>:[bw1, bw2, ...]:[r11 r12 ...; r21 r22 ...]``, with the per-dim
std-dev bandwidths and the points printed row per dim, ';' between dims, as
Julia prints a matrix, so strings round-trip with the reference.  The
format holds one bandwidth per dim (src/StringSerialization.jl:2).

Array checkpoints: a KDE is determined by its points, variances, weights
and multi-bandwidth flag, saved as an ``.npz`` in the JAX package's layout.
"""

from __future__ import annotations

import re
import warnings

import numpy as np
import torch

from . import manifolds
from .density import KDE, kde


def _warn_hooks_dropped(p: KDE, fmt: str) -> None:
    """Manifold hooks are callables and ride neither format (the
    reference's string has no hook field); say so instead of silently
    flattening a circular density to Euclidean."""
    if not all(manifolds.is_euclidean(getattr(p, attr), default)
               for attr, default in manifolds.HOOK_DEFAULTS):
        warnings.warn(
            f"{fmt} serialization drops the density's manifold hooks "
            "(addop/diffop/get_mu/get_lambda are callables); re-attach "
            "them when reconstructing", stacklevel=3)


def to_string(p: KDE) -> str:
    """The reference's string form of ``p``.  A density whose kernels do
    not share one bandwidth keeps only the first kernel's, with a
    warning."""
    _warn_hooks_dropped(p, "string")
    pts = p.host_points()
    bw_all = p.host_bw_std()
    if p.multibandwidth or not np.allclose(bw_all, bw_all[:, :1]):
        warnings.warn(
            "string serialization keeps only the first kernel's bandwidth "
            "per dimension (reference format limitation); use save_kde "
            "(npz) for multibandwidth densities", stacklevel=2)
    bw_s = "[" + ", ".join(repr(float(v)) for v in bw_all[:, 0]) + "]"
    rows = "; ".join(" ".join(repr(float(v)) for v in row) for row in pts)
    return f"KDE:{pts.shape[1]}:{bw_s}:[{rows}]"


def from_string(s: str, *, device=None, dtype=None) -> KDE:
    """Parse the reference's string form into a KDE on ``device`` (default
    ``config.DEVICE``, the card) in ``dtype`` (as :func:`kde`)."""
    if not s.startswith("KDE:"):
        raise ValueError("not a serialized KDE string")
    parts = s.split(":")
    n = int(parts[1])
    bw = np.array([float(x) for x in parts[2].strip("[] ").split(",")])
    rows = [r.strip() for r in parts[3].strip()[1:-1].split(";")]
    if len(rows) != bw.size:
        raise ValueError("dims mismatch between bandwidth and points")
    pts = np.array([[float(x) for x in re.split(r"\s+", r) if x]
                    for r in rows])
    if pts.shape != (bw.size, n):
        raise ValueError(f"expected [{bw.size}, {n}] points, got {pts.shape}")
    return kde(pts, bw, device=device, dtype=dtype)


def save_kde(path: str, p: KDE) -> None:
    """Write ``p`` as an npz (points and variances ``[N, d]``, weights
    ``[N]``, in the density's dtype, and the multi-bandwidth flag)."""
    _warn_hooks_dropped(p, "npz")
    np_dt = torch.empty((), dtype=p.dtype).numpy().dtype
    if p._host_points is not None:
        arrs = (p._host_points, p._host_bw, p._host_weights)
    else:
        arrs = (p.points, p.bw, p.weights)
    pts, bw, w = (np.asarray(x.detach().cpu().numpy()
                             if isinstance(x, torch.Tensor) else x,
                             dtype=np_dt) for x in arrs)
    np.savez(path, points=pts, bw=bw, weights=w,
             multibandwidth=np.asarray(p.multibandwidth))


def load_kde(path: str, *, device=None, dtype=None) -> KDE:
    """Read an npz written by :func:`save_kde` (or by the JAX package's)
    into a KDE on ``device`` (default ``config.DEVICE``, the card);
    ``dtype`` defaults to the stored arrays'."""
    with np.load(path) as z:
        pts = z["points"]
        return KDE(pts, z["bw"], z["weights"],
                   multibandwidth=bool(z["multibandwidth"]), device=device,
                   dtype=dtype or torch.from_numpy(pts[:0]).dtype)
