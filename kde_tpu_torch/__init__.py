"""kde_tpu_torch -- the PyTorch + CUDA port of ``kde_tpu``.

Kernel density estimates with LOOCV bandwidth selection, evaluation, and
approximate products of KDEs by multiscale Gibbs sampling, on torch tensors.
The layout mirrors ``kde_tpu`` module for module; the one hand-written
kernel, ``csrc/tiled_eval.cu``, replaces the JAX package's Pallas kernel
(``kde_tpu/ops/pallas_eval.py``) for the Hopper GPUs (sm_90a).  The
package imports torch and numpy, never JAX.
"""

from .convert import kde_from_numpy
from .density import KDE, kde
from .ops.gibbs import (BatchedProductSampler, ProductSampler,
                        prod_appx_ms_gibbs, product, product_batched)
from .utils.random import set_seed

__all__ = ["KDE", "kde", "prod_appx_ms_gibbs", "product", "ProductSampler",
           "BatchedProductSampler", "product_batched", "set_seed",
           "kde_from_numpy"]
