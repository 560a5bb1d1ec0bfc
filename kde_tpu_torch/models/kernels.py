"""Kernel-type marker (ports ``kde_tpu/models/kernels.py``; reference
``GaussianKer``/``getType``, src/BallTreeDensity01.jl:3-5,49).

The package is Gaussian-only by construction: the node statistics merge by
moment matching (src/BallTreeDensity01.jl:178-180), ``kde`` squares
bandwidths into variances (src/KDE01.jl:45), and the Gibbs engine's
information-form kernel products (src/MSGibbs01.jl:176-216) are closed only
under Gaussians.  The marker is kept for API compatibility
(``KDE.kernel_type``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KernelFamily:
    name: str


GaussianKernel = KernelFamily(name="Gaussian")
