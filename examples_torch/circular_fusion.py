"""On-manifold density fusion: products of angular (S^1) beliefs, on
kde_tpu_torch (twin of examples/circular_fusion.py).

The robotics NBP use case the manifold hooks exist for (reference threads
addop/diffop/getMu/getLambda through every layer, src/MSGibbs01.jl:672-675):
two heading estimates concentrated just either side of +/-pi.  A Euclidean
product would put the fused mass near 0 -- the opposite side of the circle;
the circular hooks wrap correctly, and they ride on the densities
themselves, so the plain `*` operator stays on-manifold.

Run: python examples_torch/circular_fusion.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from kde_tpu_torch import config, kde, manifolds, set_seed  # noqa: E402

CIRC = dict(addop=(manifolds.circular_add,),
            diffop=(manifolds.circular_diff,),
            get_mu=(manifolds.circular_mu,),
            get_lambda=(manifolds.circular_lambda,))


def wrap(a):
    return a - 2 * np.pi * np.round(a / (2 * np.pi))


def main(device=None, n=200):
    device = config.default_device(device)
    set_seed(0)
    rng = np.random.default_rng(0)
    # two heading beliefs straddling the +/-pi wrap point
    a = wrap(np.pi - 0.2 + 0.05 * rng.normal(size=(1, n)))
    b = wrap(-np.pi + 0.2 + 0.05 * rng.normal(size=(1, n)))
    pa = kde(a, [0.1], **CIRC, device=device)
    pb = kde(b, [0.1], **CIRC, device=device)

    fused = pa * pb                   # hooks flow through the Gibbs engine
    pts = fused.get_points()[0].double().cpu().numpy()
    dist_to_pi = np.abs(wrap(pts - np.pi))
    near0 = float(np.mean(np.abs(pts) < 1.0))
    print(f"fused heading: median distance to pi = "
          f"{np.median(dist_to_pi):.3f} rad (Euclidean product would sit "
          f"near 0: {near0:.0%} of mass there)")
    assert np.median(dist_to_pi) < 0.5
    hooked = fused.addop[0] is manifolds.circular_add
    print("output density carries the circular hooks:", hooked)
    assert hooked
    return {"median_distance_to_pi": float(np.median(dist_to_pi)),
            "mass_near_0": near0}


if __name__ == "__main__":
    main()
