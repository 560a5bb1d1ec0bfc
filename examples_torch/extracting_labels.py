"""Capturing the Gibbs sampler's final label selection per sample on
kde_tpu_torch (twin of examples/extracting_labels.py; reference
examples/ExtractingLabels.jl): with add_entropy=False, each product point
must equal the information-weighted mean of the kernels the labels select.

Run: python examples_torch/extracting_labels.py
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from kde_tpu_torch import config, kde, prod_appx_ms_gibbs  # noqa: E402

ATOL = 1e-4      # float32 products of three unit-bandwidth kernels


def main(device=None, n_out=3):
    device = config.default_device(device)
    dens = [kde(np.array(c), [1.0], device=device)
            for c in ([1.0, 2.0, 3.0], [0.5, 1.5, 2.5], [4.0, 5.0, 6.0])]
    pts, idx, labels = prod_appx_ms_gibbs(
        n_out, dens, n_iter=5, add_entropy=False, record_labels=True, key=0)
    pts, idx = pts.cpu().numpy(), idx.cpu().numpy()
    errs = []
    for s in range(n_out):
        mus = [float(d.get_points()[0, idx[j, s]]) for j, d in
               enumerate(dens)]
        mu = np.mean(mus)   # equal unit bandwidths -> arithmetic mean
        errs.append(abs(mu - pts[0, s]))
        print(f"sample {s}: labels={idx[:, s].tolist()} "
              f"reconstructed mu={mu:.4f} returned={pts[0, s]:.4f}")
    print("per-level label record shape:", tuple(labels.shape))
    if max(errs) > ATOL:
        raise AssertionError(f"a product point is {max(errs)} from its "
                             "labels' mean")
    return {"labels": idx.tolist(), "max_abs_err": float(max(errs)),
            "label_record_shape": list(labels.shape)}


if __name__ == "__main__":
    main()
