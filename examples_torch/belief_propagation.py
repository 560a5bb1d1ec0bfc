"""Nonparametric belief propagation on a small chain graph, on
kde_tpu_torch (twin of examples/belief_propagation.py).

The reference's primary downstream consumer (IncrementalInference.jl) runs
loopy NBP: every iteration multiplies, at each variable node, the incoming
message densities (Sudderth/Ihler NIPS-2003 -- the algorithm
``prodAppxMSGibbsS`` implements, reference src/MSGibbs01.jl:668-669).
This demo runs synchronous NBP on a 1-D chain of position variables
x0 -- x1 -- x2 with pairwise "offset by ~delta" potentials and a unary
measurement at each end, drawing every node's message product in one
``BatchedProductSampler`` call per iteration.  The messages are shifted on
the device, so the loop keeps the beliefs there (device-built plans) and
reads the means back only after it.

Run: python examples_torch/belief_propagation.py
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from kde_tpu_torch import BatchedProductSampler, config, kde  # noqa: E402

DELTA = 5.0        # true offset between neighboring variables


def shift(msg, delta, gen):
    """Propagate a belief through the pairwise potential x_j = x_i + delta
    (+ process noise): shift the kernel centers on the device."""
    pts = msg.get_points()
    noise = 0.3 * torch.randn(pts.shape, generator=gen, dtype=pts.dtype,
                              device=pts.device)
    return kde(pts + delta + noise, [0.6])


def main(device=None, n=128, iters=3):
    """``n`` kernels per message, ``iters`` NBP iterations."""
    device = config.default_device(device)
    rng = np.random.default_rng(0)
    f32 = dict(device=device, dtype=torch.float32)
    # unary evidence: x0 measured near 0, x2 measured near 2*DELTA
    prior_x0 = kde(rng.normal(0.0, 0.6, size=(1, n)), [0.5], **f32)
    prior_x2 = kde(rng.normal(2 * DELTA, 0.6, size=(1, n)), [0.5], **f32)
    # x1 starts diffuse between them
    belief = [prior_x0,
              kde(rng.uniform(-2, 2 * DELTA + 2, size=(1, n)), [2.0], **f32),
              prior_x2]
    gen = torch.Generator(device=device)
    gen.manual_seed(100)
    sampler = None
    mean_trace = []
    for it in range(iters):
        # messages into each node from its neighbors (+ unary where present)
        sets = [
            [prior_x0, shift(belief[1], -DELTA, gen)],             # into x0
            [shift(belief[0], +DELTA, gen),
             shift(belief[2], -DELTA, gen)],                       # into x1
            [prior_x2, shift(belief[1], +DELTA, gen)],             # into x2
        ]
        if sampler is None:
            sampler = BatchedProductSampler(sets, n_out=n, n_iter=5)
        else:
            sampler.refresh(sets)     # same shapes: the plans are rebuilt
        pts, _ = sampler.sample(it)
        belief = [kde(pts[i], [0.5]) for i in range(3)]   # on the device
        mean_trace.append(torch.stack([b.points.mean() for b in belief]))

    for it, ms in enumerate(torch.stack(mean_trace).double().cpu().numpy()):
        means = ms.tolist()
        print(f"iter {it}: belief means = "
              + ", ".join(f"x{i}={m:6.2f}" for i, m in enumerate(means)))

    assert abs(means[0] - 0.0) < 1.5
    assert abs(means[1] - DELTA) < 2.0
    assert abs(means[2] - 2 * DELTA) < 1.5
    print("NBP converged to the expected chain geometry.")
    return {"means": means}


if __name__ == "__main__":
    main()
