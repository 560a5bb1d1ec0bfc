"""Evaluating fitted densities at query points on kde_tpu_torch (twin of
examples/evaluating_densities.py; reference examples/EvaluatingDensities.jl).

Run: python examples_torch/evaluating_densities.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from kde_tpu_torch import config, kde  # noqa: E402


def main(device=None, n_1d=100, n_3d=75):
    device = config.default_device(device)
    rng = np.random.default_rng(0)

    # 1-D: vector of evaluation points
    p1 = kde(rng.normal(size=(1, n_1d)), device=device)
    y = p1.evaluate(np.arange(-2.0, 2.1, 0.1)).cpu().numpy()
    print("1D eval:", np.round(y[:4], 5), "...")

    # 3-D: column-per-point matrix
    p3 = kde(rng.normal(size=(3, n_3d)), device=device)
    v = np.array([[0.0, 1.0], [0.0, 0.0], [0.0, 0.0]])
    y3 = p3.evaluate(v).cpu().numpy()
    print("3D eval at origin & (1,0,0):", np.round(y3, 5))
    if not (np.all(np.isfinite(y)) and np.all(y > 0)
            and np.all(np.isfinite(y3)) and np.all(y3 > 0)):
        raise AssertionError("a density value is not finite and positive")
    return {"eval_1d_head": y[:4].tolist(), "n_eval_1d": len(y),
            "eval_3d": y3.tolist()}


if __name__ == "__main__":
    main()
