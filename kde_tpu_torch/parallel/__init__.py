"""Distributed layer over ``torch.distributed`` (ports ``kde_tpu/parallel``):
meshes, chain-, set- and kernel-sharded products, sharded evaluation and
LOOCV, multi-host start-up and product sizing.

One process drives one device.  Start every rank with
:func:`initialize_multihost`, build a mesh with :func:`make_mesh` /
:func:`make_mesh_2d`, and call each sharded entry point with the same
arguments on every rank.  The scale axes are ``chains`` (Gibbs chains,
query points: data parallel) and ``kernels`` (mixture components:
collective log-sum-exp and CDF reductions).  ``import kde_tpu_torch`` does
not import this package.
"""

from .mesh import CHAINS, KERNELS, make_mesh, make_mesh_2d
from .product import (initialize_multihost, prod_appx_ms_gibbs_sharded,
                      product_sharded)
from .gibbs_kernel_sharded import prod_appx_ms_gibbs_kernel_sharded
from .eval import (ksize_bandwidths_sharded, sharded_log_eval,
                   sharded_loo_entropy)
from .sizing import estimate_product_memory, recommend_shards

__all__ = [
    "CHAINS", "KERNELS", "make_mesh", "make_mesh_2d",
    "initialize_multihost", "prod_appx_ms_gibbs_sharded", "product_sharded",
    "prod_appx_ms_gibbs_kernel_sharded",
    "ksize_bandwidths_sharded", "sharded_log_eval", "sharded_loo_entropy",
    "estimate_product_memory", "recommend_shards",
]
