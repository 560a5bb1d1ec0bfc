"""Build the port's KDE from the arrays that define a density.

A ``kde_tpu.KDE`` is fully defined by its points, per-kernel variances,
normalized weights and its multi-bandwidth flag; those arrays play the part
of a model's weights.  ``kde_from_numpy`` turns them into a
``kde_tpu_torch.KDE``, so both packages can be given the same density.
"""

from __future__ import annotations

import numpy as np

from .density import KDE


def kde_from_numpy(points_nd: np.ndarray, var_nd: np.ndarray,
                   weights: np.ndarray, multibandwidth: bool, *,
                   device="cpu", dtype=None) -> KDE:
    """``points [N, d]``, variances ``[N, d]`` and weights ``[N]`` (NumPy)
    -> a KDE on ``device`` in ``dtype`` (default
    ``torch.get_default_dtype()``)."""
    points_nd = np.asarray(points_nd, dtype=np.float64)
    n, d = points_nd.shape
    var_nd = np.broadcast_to(np.asarray(var_nd, dtype=np.float64), (n, d))
    weights = np.asarray(weights, dtype=np.float64).reshape(n)
    return KDE(points_nd, var_nd, weights, multibandwidth,
               device=device, dtype=dtype)
