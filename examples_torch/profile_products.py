"""Timing harness for products on kde_tpu_torch (twin of
examples/profile_products.py; reference examples/ProfileProducts.jl), plus
the large-scale config from BASELINE.md.

On the card each product is timed with CUDA events around ``reps`` calls
after a warm-up call, ending in ``torch.cuda.synchronize()`` (no profiler),
and every number is printed beside the card's name and power limit
(``nvidia-smi``).  On the CPU the host clock times it and the line says so.

Run: python examples_torch/profile_products.py
"""
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from kde_tpu_torch import config, kde, prod_appx_ms_gibbs  # noqa: E402

# (components per density, samples, dims): the reference's ProfileProducts
# config, then the BASELINE.md headline config
CONFIGS = ((100, 100, 1), (1000, 1000, 2))


def device_label(device) -> str:
    """The card's ``name, power limit`` (nvidia-smi), or what the CPU
    timer is."""
    if device.type != "cuda":
        return "cpu, host clock"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def profile(device, n_comp, n_out, n_iter=5, d=1, reps=5, label=""):
    """Milliseconds per product of two ``n_comp``-component ``d``-dim
    densities with ``n_out`` samples."""
    rng = np.random.default_rng(0)
    dens = [kde(rng.normal(size=(d, n_comp)), [0.2], device=device,
                dtype=torch.float32) for _ in range(2)]
    for p in dens:
        p.tree
    prod_appx_ms_gibbs(n_out, dens, n_iter=n_iter, key=0)      # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for r in range(reps):
            prod_appx_ms_gibbs(n_out, dens, n_iter=n_iter, key=r + 1)
        end.record()
        torch.cuda.synchronize(device)
        ms = start.elapsed_time(end) / reps
    else:
        t0 = time.perf_counter()
        for r in range(reps):
            prod_appx_ms_gibbs(n_out, dens, n_iter=n_iter, key=r + 1)
        ms = 1e3 * (time.perf_counter() - t0) / reps
    rate = n_out / (ms / 1e3)
    print(f"2x{n_comp}-comp {d}D product, {n_out} samples: {ms:.3f} ms -> "
          f"{rate:,.0f} samples/s [{label}]")
    if not (np.isfinite(ms) and ms > 0):
        raise AssertionError(f"a product time of {ms} ms")
    return {"n_comp": n_comp, "n_out": n_out, "d": d, "ms": ms,
            "samples_per_s": rate, "device": label}


def main(device=None, configs=CONFIGS, reps=5):
    device = config.default_device(device)
    label = device_label(device)
    return {"rows": [profile(device, n_comp, n_out, d=d, reps=reps,
                             label=label)
                     for n_comp, n_out, d in configs]}


if __name__ == "__main__":
    main()
