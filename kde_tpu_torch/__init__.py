"""kde_tpu_torch -- the PyTorch + CUDA port of ``kde_tpu``.

Kernel density estimates with LOOCV bandwidth selection, evaluation,
functionals, sampling, serialization and approximate products of KDEs by
multiscale Gibbs sampling, on torch tensors, with per-dimension manifold
hooks.  The layout and the public names mirror ``kde_tpu`` module for
module; the one hand-written kernel, ``csrc/tiled_eval.cu``, replaces the
JAX package's Pallas kernel (``kde_tpu/ops/pallas_eval.py``) for the Hopper
GPUs (sm_90a).  The package imports torch and numpy, never JAX.
"""

from typing import Sequence as _Seq, Union as _Union

from . import manifolds
from .config import set_force_eval_direct
from .convert import kde_from_numpy
from .density import KDE, kde
from .functionals import (
    entropy, eval_avg_logl, evaluate_dual_tree, get_kde_fit, get_kde_max,
    get_kde_mean, get_kde_range, get_kde_range_linspace, inters_intg_appx_is,
    kld, minkld,
)
from .ops.balltree import FlatBallTree, build_balltree
from .ops.gibbs import (BatchedProductSampler, ProductSampler,
                        prod_appx_ms_gibbs, product, product_batched)
from .ops.loocv import golden_batched, ksize, nloo_ll
from .ops.sampling import rand_kde, resample, sample, sample_at
from .serialization import from_string, load_kde, save_kde, to_string
from .utils.random import set_seed

# The reference's golden-section search (src/CrossValidation.jl:44-98), in
# batched form: it minimizes a vectorized objective over many brackets.
golden = golden_batched

# The reference's type names: ``BallTreeDensity <: MixtureDensity``
# (src/BallTreeDensity01.jl:9-24) and the argument alias ``VectorRange``
# (src/KernelDensityEstimate.jl:63).
BallTreeDensity = KDE
MixtureDensity = KDE
BallTree = FlatBallTree
VectorRange = _Union[_Seq[int], _Seq[float], range]


def marginal(p: KDE, dims):
    """Free-function form of ``marginal(p, dims)`` (src/KDE01.jl:143-153)."""
    return p.marginal(dims)


def root(p) -> int:
    """Root node slot of a density's ball tree (reference ``root``,
    src/BallTree01.jl:64): slot 0 in the 0-based slot convention."""
    return 0


def npts(p) -> int:
    """Number of kernels (reference ``Npts``, src/BallTree01.jl:66)."""
    return p.npts


def ndim(p) -> int:
    """Dimensionality (reference ``Ndim``, src/BallTree01.jl:65)."""
    return p.ndim


__all__ = [
    "KDE", "kde",
    "entropy", "eval_avg_logl", "kld", "minkld", "inters_intg_appx_is",
    "get_kde_range", "get_kde_range_linspace", "get_kde_max", "get_kde_mean",
    "get_kde_fit",
    "sample", "sample_at", "rand_kde", "resample",
    "to_string", "from_string", "save_kde", "load_kde",
    "BatchedProductSampler", "ProductSampler", "prod_appx_ms_gibbs",
    "product", "product_batched",
    "evaluate_dual_tree", "ksize", "nloo_ll", "golden", "golden_batched",
    "FlatBallTree", "build_balltree",
    "BallTreeDensity", "MixtureDensity", "BallTree", "VectorRange",
    "marginal", "npts", "ndim", "root",
    "set_seed", "set_force_eval_direct", "manifolds", "kde_from_numpy",
]
