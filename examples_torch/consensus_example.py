"""Consensus fusion of several measurement densities on kde_tpu_torch
(twin of examples/consensus_example.py; reference
examples/ConsensusExample.jl): a broad prior fused with two- and three-way
products, the three-way one chain-sharded when this process is a rank of an
initialized ``torch.distributed`` world of more than one rank.

Run: python examples_torch/consensus_example.py
(or under ``torchrun --nproc-per-node N`` after
``kde_tpu_torch.parallel.initialize_multihost()``; every rank runs it).
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from kde_tpu_torch import config, kde, prod_appx_ms_gibbs, resample  # noqa: E402,E501


def main(device=None, n=300):
    """``n`` samples per resampled measurement density and product.  Every
    rank builds the same densities (explicit keys)."""
    device = config.default_device(device)
    p = resample(kde(np.array([0.0]), [10.0], device=device), n,
                 key=1)                                   # broad prior
    q = resample(kde(np.array([-8.0, 13.0]), [1.5], device=device), n,
                 key=2)                                   # bimodal evidence
    r = resample(kde(np.array([-35.0, -11.0, 26.0]), [2.5], device=device),
                 n, key=3)

    pq = p * q
    pq_mean = float(pq.get_points().double().mean())
    print("p*q modes (sample mean):", pq_mean)

    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if world > 1:
        from kde_tpu_torch.parallel import (make_mesh,
                                            prod_appx_ms_gibbs_sharded)
        pgm, _ = prod_appx_ms_gibbs_sharded(make_mesh(), n, [p, q, r],
                                            n_iter=5)
        print(f"sharded 3-way consensus over {world} ranks")
    else:
        pgm, _ = prod_appx_ms_gibbs(n, [p, q, r], n_iter=5, key=4)
    kde(pgm)
    lo, hi = float(pgm.min()), float(pgm.max())
    print("p*q*r support:", np.round([lo, hi], 2))
    if not (np.isfinite(pq_mean) and np.isfinite(lo) and np.isfinite(hi)):
        raise AssertionError("a consensus product is not finite")
    return {"pq_mean": pq_mean, "support": [lo, hi], "world": world,
            "points": pgm.cpu().numpy()}


if __name__ == "__main__":
    main()
