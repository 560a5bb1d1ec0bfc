#!/usr/bin/env python3
"""Drive the kde_tpu_torch main path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line of findings each:
  1. device: the card's name and power limit, torch/CUDA versions, TF32
     flags (both off);
  2. build: nvcc compiles kde_tpu_torch/csrc/tiled_eval.cu (sm_90a);
  3. the kernel against its plain torch twin on the card at four shapes,
     rtol = atol = 2e-4, with CUDA-event times of both at (a) and (b);
  4. the `*` slice at 2 x 20,000 components in 2-D: LOOCV fits, the Gibbs
     product (20,000 chains, Niter 5), the LOOCV refit of the samples and
     the evaluation at 20,000 queries -- each stage must launch the kernel;
  5. serving: ProductSampler over 2 x 50,000-component densities,
     256 chains per request.
Then one JSON line on the kernels, and last the device JSON line.  Any
failed check raises, so the script exits nonzero and prints no result.  It
refuses to run without a card.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
N_SLICE = 20_000
N_SERVE = 50_000
SERVE_CHAINS = 256
SERVE_CALLS = 5
RTOL = ATOL = 2e-4       # tests/test_pallas_eval.py: f32 sums in another order


def _sync():
    import torch
    torch.cuda.synchronize()


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def _cuda_ms(fn, reps=5):
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events,
    after one warm-up run."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare(got, want, what):
    """Max |got - want| over the finite entries; raises if -inf positions
    differ or any entry is outside rtol = atol = 2e-4."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        raise AssertionError(f"{what}: -inf positions differ")
    fin = torch.isfinite(want)
    if not torch.isfinite(got[fin]).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (got[fin].double() - want[fin].double()).abs()
    bound = ATOL + RTOL * want[fin].double().abs()
    if bool((err > bound).any()):
        raise AssertionError(f"{what}: max |err| {float(err.max())} "
                             f"outside rtol=atol={RTOL}")
    return float(err.max()) if err.numel() else 0.0


def phase_kernel(dev):
    """Phase 3: kernel vs plain twin at the main path's shapes."""
    import torch
    from kde_tpu_torch.ops import tiled_eval
    rng = np.random.default_rng(SEED)

    def inputs(m, n, d, loo):
        mu = rng.normal(size=(n, d))
        q = mu if loo else rng.normal(size=(m, d))
        var = rng.uniform(0.005, 0.05, size=(n, d))
        w = rng.uniform(0.1, 1.0, size=n)
        return [torch.as_tensor(x, dtype=torch.float32, device=dev)
                for x in (q, mu, var, w / w.sum())]

    cases = {"a": (N_SLICE, N_SLICE, 2, False), "b": (N_SLICE, N_SLICE, 1, True),
             "c": (1000, 777, 3, False), "d": (1, 1, 1, True)}
    rows, worst = {}, 0.0
    for name, (m, n, d, loo) in cases.items():
        args = inputs(m, n, d, loo)
        got = tiled_eval.tiled_log_eval(*args, loo=loo)
        _sync()
        want = tiled_eval.tiled_log_eval_ref(*args, loo=loo)
        err = compare(got, want, f"case ({name})")
        worst = max(worst, err)
        row = {"M": m, "N": n, "d": d, "loo": loo, "max_abs_err": err}
        if name == "d" and not bool(torch.isneginf(got).all()):
            raise AssertionError("case (d): the all-masked row is not -inf")
        if name in ("a", "b"):
            row["ms"] = _cuda_ms(lambda: tiled_eval.tiled_log_eval(*args, loo=loo))
            row["plain_ms"] = _cuda_ms(
                lambda: tiled_eval.tiled_log_eval_ref(*args, loo=loo))
        rows[name] = row
        print(f"kernel ({name}): {json.dumps(row)}", flush=True)
    return rows, worst


def phase_slice(dev, n=N_SLICE, seed=SEED):
    """Phase 4: the `*` slice; returns per-stage seconds and launches."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import gibbs, kernels, tiled_eval
    rng = np.random.default_rng(seed)
    f32 = lambda x: torch.as_tensor(x.astype(np.float32), device=dev)
    a = f32(rng.normal(size=(2, n)))
    b = f32(rng.normal(size=(2, n)) + 0.5)
    queries = f32(rng.normal(size=(2, n)))
    sync = _sync if dev.type == "cuda" else (lambda: None)
    stages, launches = {}, {}

    sync()
    t0, l0 = time.perf_counter(), tiled_eval.LAUNCHES
    p, q = kt.kde(a), kt.kde(b)
    sync()
    stages["fit"], launches["fit"] = (time.perf_counter() - t0,
                                      tiled_eval.LAUNCHES - l0)

    # the host ball trees the product's level plan is built from (cached
    # on the densities, so `p * q` below reuses them)
    t0 = time.perf_counter()
    p.tree, q.tree
    stages["trees"] = time.perf_counter() - t0

    # `p * q` runs the Gibbs chains and then refits the samples with
    # gibbs.kde; wrap that call to split the two stages' times and launches
    marks = {}
    refit = gibbs.kde

    def timed_refit(pts, *args, **kw):
        sync()
        marks["gibbs"] = (time.perf_counter(), tiled_eval.LAUNCHES)
        out = refit(pts, *args, **kw)
        sync()
        marks["refit"] = (time.perf_counter(), tiled_eval.LAUNCHES)
        return out

    kt.set_seed(seed)
    gibbs.kde = timed_refit
    try:
        t0, l0 = time.perf_counter(), tiled_eval.LAUNCHES
        pq = p * q
    finally:
        gibbs.kde = refit
    stages["gibbs"] = marks["gibbs"][0] - t0
    launches["gibbs"] = marks["gibbs"][1] - l0
    stages["refit"] = marks["refit"][0] - marks["gibbs"][0]
    launches["refit"] = marks["refit"][1] - marks["gibbs"][1]

    sync()
    t0, l0 = time.perf_counter(), tiled_eval.LAUNCHES
    lp = pq.log_eval(queries)
    sync()
    stages["evaluate"], launches["evaluate"] = (time.perf_counter() - t0,
                                                tiled_eval.LAUNCHES - l0)

    # checks, by the repo's own means
    for stage in ("fit", "refit", "evaluate"):
        if launches[stage] < 1 and dev.type == "cuda":
            raise AssertionError(f"stage {stage} never launched the kernel")
    if pq.npts != n or lp.shape != (n,) or not bool(torch.isfinite(lp).all()):
        raise AssertionError("product/evaluation: wrong size or non-finite")
    for k in (p, q, pq):
        if not (bool(torch.isfinite(k.bw).all()) and bool((k.bw > 0).all())):
            raise AssertionError("a bandwidth is not finite and positive")
    bw = torch.sqrt(p.bw[0]).cpu().numpy()
    if not np.all((bw > 0.25 * 1.06 * n ** -0.2) & (bw < 4 * 1.06 * n ** -0.2)):
        raise AssertionError(f"LOOCV bandwidths {bw} far from Silverman's")
    mean = pq.points.double().mean(dim=0).cpu().numpy()
    # N(0, I) x N(0.5, I): the product's mean is 0.25 in each dimension,
    # standard error ~0.005 at 20,000 samples (the bound widens only for
    # the small sizes of a rehearsal on the CPU)
    if not np.all(np.abs(mean - 0.25) < max(0.05, 4.0 / np.sqrt(n))):
        raise AssertionError(f"product sample mean {mean} not near 0.25")
    m_ref = min(n, 2000)
    ref = kernels.log_eval(queries[:, :m_ref].T.double().cpu(),
                           pq.points.double().cpu(), pq.bw.double().cpu(),
                           pq.weights.double().cpu(),
                           chunk=max(1, (1 << 22) // n))
    err = compare(lp[:m_ref].cpu(), ref.float(), "evaluate vs float64 CPU")
    return dict(seconds=stages, launches=launches, product_mean=mean.tolist(),
                fit_bw=bw.tolist(), refit_bw=torch.sqrt(pq.bw[0]).tolist(),
                eval_err_vs_f64=err)


def phase_serve(dev, n=N_SERVE, seed=SEED):
    """Phase 5: ProductSampler over 2 x n components (bench.py scale row)."""
    import torch
    import kde_tpu_torch as kt
    rng = np.random.default_rng(seed + 1)
    bw = [float(1.06 * n ** -0.2)]
    dens = [kt.kde(rng.normal(size=(2, n)).astype(np.float32), bw,
                   device=dev, dtype=torch.float32),
            kt.kde((rng.normal(size=(2, n)) + 0.5).astype(np.float32), bw,
                   device=dev, dtype=torch.float32)]
    sync = _sync if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    sampler = kt.ProductSampler(dens, n_out=SERVE_CHAINS, n_iter=5)
    pts, _ = sampler.sample(seed)
    sync()
    first = time.perf_counter() - t0
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    outs = [sampler.sample(gen)[0] for _ in range(SERVE_CALLS)]
    sync()
    dt = time.perf_counter() - t0
    for o in [pts] + outs:
        if o.shape != (2, SERVE_CHAINS) or not bool(torch.isfinite(o).all()):
            raise AssertionError("serving: wrong shape or non-finite sample")
    return dict(first_call_s=first, calls=SERVE_CALLS, seconds=dt,
                samples_per_s=SERVE_CALLS * SERVE_CHAINS / dt)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: "
                         "torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kde_tpu_torch.ops import tiled_eval
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card()

    # 1. device
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    so = tiled_eval.build()
    ptxas = [ln.strip() for ln in tiled_eval.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(so)}; ptxas: {ptxas[:4]}", flush=True)

    # 3. kernel vs plain twin
    rows, worst = phase_kernel(dev)

    # 4 + 5. the main path; only its launches count
    tiled_eval.LAUNCHES = 0
    sl = phase_slice(dev)
    sv = phase_serve(dev)
    main_launches = tiled_eval.LAUNCHES
    if main_launches < 1:
        raise AssertionError("the main path never launched the kernel")
    print(f"slice 2x{N_SLICE} 2-D `*` on {card}: {json.dumps(sl)}",
          flush=True)
    print(f"serve 2x{N_SERVE} comps, {SERVE_CHAINS} chains on {card}: "
          f"{json.dumps(sv)}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "tiled_log_eval", "route": "cuda",
        "source": "kde_tpu_torch/csrc/tiled_eval.cu",
        "replaces": "kde_tpu/ops/pallas_eval.py:31",
        "launches": main_launches, "max_abs_err": worst,
        "ms": rows["a"]["ms"], "plain_ms": rows["a"]["plain_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
