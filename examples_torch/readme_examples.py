"""The reference README's workflows on kde_tpu_torch (twin of
examples/readme_examples.py, the five BASELINE.json configurations).

Run: python examples_torch/readme_examples.py
(plotting is out of scope, as in the reference, which splits it into
KernelDensityEstimatePlotting.jl; each example prints summary statistics).
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from kde_tpu_torch import (config, get_kde_max, kde,  # noqa: E402
                           prod_appx_ms_gibbs, resample, set_seed)


def example_1d_lcv(device, n=100):
    """Basic 1-D: LOOCV fit of a bimodal sample + fixed-bw fit + resample
    (reference README.md:36-38)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=n // 2),
                        10.0 + 2.0 * rng.normal(size=n // 2)])
    p100 = kde(x, device=device)                  # LOOCV bandwidth
    p2 = kde(np.array([0.0, 10.0]), [1.0], device=device)
    p75 = resample(p2, 75)
    bw = float(p100.get_bw()[0, 0])
    print(f"1D LCV: bw={bw:.4f}, resampled Npts={p75.npts}")
    return {"bw": bw, "resampled_npts": p75.npts}


def example_multidim_marginals(device, n=100):
    """3-D LOOCV fit + chained marginals (reference README.md:46-51)."""
    rng = np.random.default_rng(1)
    pd2 = kde(rng.normal(size=(3, n)), device=device)
    pm12 = pd2.marginal([0, 1])
    pm2 = pm12.marginal([1])
    bws = pd2.get_bw()[:, 0].cpu().numpy()
    print(f"3D fit bws={np.round(bws, 4)}, marginal dims={pm2.ndim}")
    return {"bws": bws.tolist(), "marginal_dims": pm2.ndim}


def example_2d_product(device, n=100, mcmc=5):
    """2-D Gibbs product of two 100-component KDEs
    (reference README.md:53-61)."""
    rng = np.random.default_rng(2)
    p = kde(rng.normal(size=(2, n)), device=device)
    q = kde(2.0 + rng.normal(size=(2, n)), device=device)
    pgm, _ = prod_appx_ms_gibbs(n, [p, q], n_iter=mcmc)
    pq = kde(pgm)
    pq.marginal([0])
    mean = pgm.double().mean(dim=1).cpu().numpy()
    print(f"2D product: mean={np.round(mean, 3)} (expect ~[1, 1])")
    return {"mean": mean.tolist()}


def example_beta_rayleigh(device, n_beta=300, n_ray=100):
    """Non-Gaussian 1-D product: Beta(1, 0.45) x (Rayleigh(0.5) - 0.5)
    (reference README.md:74-80)."""
    rng = np.random.default_rng(3)
    beta = rng.beta(1.0, 0.45, size=n_beta)
    rayl = rng.rayleigh(0.5, size=n_ray) - 0.5
    p = kde(beta, device=device)
    q = kde(rayl, device=device)
    pgm, _ = prod_appx_ms_gibbs(100, [p, q], n_iter=5)
    pq = kde(pgm)
    mode, mean = float(get_kde_max(pq)[0]), float(pgm.double().mean())
    print(f"Beta x Rayleigh product: mode~{mode:.3f}, mean={mean:.3f}")
    return {"mode": mode, "mean": mean}


def example_4d_multimodal(device, n=200):
    """4-D multimodal product with marginals over dims 2:4
    (reference README.md:85-97)."""
    rng = np.random.default_rng(4)
    pts = np.vstack([
        2 * rng.normal(size=(1, n)) + 3,
        np.concatenate([2 * rng.normal(size=n // 2) + 3.0,
                        2 * rng.normal(size=n // 2) - 3.0])[None, :],
        2 * rng.normal(size=(2, n)) + 3,
    ])
    p = kde(rng.normal(size=(4, 100)), device=device)
    q = kde(pts, device=device)
    pq = p * q
    pq_234 = pq.marginal([1, 2, 3])
    mean = pq.get_points().double().mean(dim=1).cpu().numpy()
    print(f"4D product: Npts={pq.npts}, marginal(2:4) dims={pq_234.ndim}, "
          f"mean={np.round(mean, 2)}")
    return {"npts": pq.npts, "marginal_dims": pq_234.ndim,
            "mean": mean.tolist()}


def main(device=None, n=100, n_beta=300, n_ray=100, n_4d=200):
    """The five workflows on ``device`` (default ``config.DEVICE``)."""
    device = config.default_device(device)
    set_seed(0)
    out = {"1d_lcv": example_1d_lcv(device, n),
           "multidim_marginals": example_multidim_marginals(device, n),
           "2d_product": example_2d_product(device, n),
           "beta_rayleigh": example_beta_rayleigh(device, n_beta, n_ray),
           "4d_multimodal": example_4d_multimodal(device, n_4d)}
    for name, res in out.items():
        if not all(np.all(np.isfinite(v)) for v in res.values()):
            raise AssertionError(f"{name}: a non-finite summary {res}")
    return out


if __name__ == "__main__":
    main()
