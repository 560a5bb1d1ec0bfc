"""SE(2) pose fusion with per-dimension MIXED manifold hooks, on
kde_tpu_torch (twin of examples/se2_fusion.py).

The full robotics NBP pattern the hook system exists for (reference threads
per-dimension addop/diffop/getMu/getLambda tuples through every layer,
src/MSGibbs01.jl:672-675; downstream IncrementalInference.jl passes SE(2)
operators): a pose belief lives on R^2 x S^1 -- x/y fuse with the ordinary
Euclidean information-form mean while the heading dimension needs circular
difference/mean arithmetic.  Hook tuples are per dimension, so one density
carries (euclid, euclid, circular) for each of the four hooks.

Two pose beliefs agree on position but straddle the +/-pi heading wrap;
the fused heading must sit at the wrap (+/-pi), not at the Euclidean
average (~0).

Run: python examples_torch/se2_fusion.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from kde_tpu_torch import config, kde, manifolds, set_seed  # noqa: E402

SE2 = dict(
    addop=(manifolds.euclid_add, manifolds.euclid_add,
           manifolds.circular_add),
    diffop=(manifolds.euclid_diff, manifolds.euclid_diff,
            manifolds.circular_diff),
    get_mu=(manifolds.euclid_mu, manifolds.euclid_mu,
            manifolds.circular_mu),
    get_lambda=(manifolds.euclid_lambda, manifolds.euclid_lambda,
                manifolds.circular_lambda),
)


def wrap(a):
    return a - 2 * np.pi * np.round(a / (2 * np.pi))


def make_pose_belief(rng, x, y, theta, n, device):
    pts = np.vstack([
        x + 0.15 * rng.normal(size=n),
        y + 0.15 * rng.normal(size=n),
        wrap(theta + 0.05 * rng.normal(size=n)),
    ])
    return kde(pts, [0.08, 0.08, 0.05], **SE2, device=device)


def main(device=None, n=300):
    device = config.default_device(device)
    set_seed(0)
    rng = np.random.default_rng(0)
    # odometry says (2, 1, pi - 0.15); the landmark update says
    # (2.3, 0.8, -pi + 0.15): same position to ~0.3 m, headings straddling
    # the wrap 0.3 rad apart THROUGH +/-pi
    pa = make_pose_belief(rng, 2.0, 1.0, np.pi - 0.15, n, device)
    pb = make_pose_belief(rng, 2.3, 0.8, -np.pi + 0.15, n, device)

    fused = pa * pb                     # hooks ride on the densities
    pts = fused.get_points().double().cpu().numpy()

    xy = pts[:2].mean(axis=1)
    dist_to_pi = np.abs(wrap(pts[2] - np.pi))
    frac_at_wrap = float(np.mean(np.abs(pts[2]) > np.pi / 2))
    print(f"fused position mean: ({xy[0]:.2f}, {xy[1]:.2f}) "
          "(expect ~(2.15, 0.90))")
    print(f"fused heading: median |theta - pi| = "
          f"{np.median(dist_to_pi):.3f} rad; {100 * frac_at_wrap:.0f}% of "
          "mass at the wrap (a Euclidean product would put it near 0)")
    assert abs(xy[0] - 2.15) < 0.2 and abs(xy[1] - 0.9) < 0.2
    assert frac_at_wrap > 0.9
    # the output density carries the SE(2) hooks forward (chainable fusion)
    assert fused.get_mu[2] is manifolds.circular_mu
    print("SE(2) fusion stayed on-manifold; hooks carried to the output.")
    return {"xy": xy.tolist(), "frac_at_wrap": frac_at_wrap}


if __name__ == "__main__":
    main()
