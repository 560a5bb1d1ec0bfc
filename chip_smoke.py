#!/usr/bin/env python3
"""Drive the kde_tpu_torch main path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line of findings each:
  1. device: the card's name and power limit, torch/CUDA versions, TF32
     flags (both off);
  2. build, all started together: nvcc compiles kde_tpu_torch/csrc/
     tiled_eval.cu and csrc/small_ops.cu (sm_90a, the latter with
     --fmad=false), g++ the native ball-tree builder csrc/balltree.cpp;
  3. the kernel against its plain torch twin on the card at five shapes,
     rtol = atol = 2e-4: (a) 20k x 20k, d = 2; (b) LOO 20k, d = 1;
     (c) 1000 x 777, d = 3; (d) LOO N = 1 (-inf); (e) LOO 100k, d = 1 (the
     unscented kld's fit); CUDA-event times of kernel and twin at (a), (b)
     and (e) beside the kernel's bound (SFU ex2 rate, FP32 rate, bytes) and,
     at (a) and (b), the dense route as context; (f) data at 10^3 against
     the float64 twin (atol 1e-4, rtol 1e-5);
 3b. the float64 small-route kernels of csrc/small_ops.cu against their
     plain twins on the card: loo_golden (one launch for every row's golden
     search) on README cfg 1 (N = 100, d = 1), N = 120 in 2-D, the 1-D gate
     edge N = 255, zero-weight kernels, N = 1 and N = 2 (selections to rtol
     1e-9); small_log_eval at 200 x 100, d = 1, at 200 x 300, d = 4 (the
     widest under the gate), LOO at N = 100 and 255 and the exp-wrap
     queries (log p to atol 1e-10).  CUDA-event times of each kernel
     (loo_golden at cfg 1, 2-D and the gate edge; small_log_eval at the
     two evaluation shapes) beside its twin, the parent's routes for the
     same call (the float32 and float64 dense golden loops, the float32
     dense evaluation), an empty launch of the same library and the bound;
     at the evaluation shapes also torch.distributions' MixtureSameFamily
     log_prob, the one PyTorch call that computes the same function;
 3c. README cfg 1 end to end with the package's defaults (kde(x), p(grid),
     resample(p, 75, "lcv"), the LOO evaluate): float64 results equal to
     the same flow on the CPU, both small kernels launched; flows/s with
     the gates at their values and with the port's gates at 0 (the
     parent's routes), in turns;
  4. the `*` slice at 2 x 20,000 components in 2-D: LOOCV fits, the host
     ball trees (built natively: two native builds; p's tree rebuilt once
     with the NumPy builder must equal it array for array), the Gibbs
     product (20,000 chains, Niter 5), the LOOCV refit of the samples and
     the evaluation at 20,000 queries -- fit, refit and evaluate must
     launch the kernel;
  5. serving: ProductSampler over 2 x 50,000-component densities,
     256 chains per request;
  6. the device-built plan at full width: device-resident copies of
     phase 4's densities (no host arrays, no tree), `p' * q'` and the
     chained `(p'q') * q'`; no host tree may be built, the refits must
     launch the kernel, the means must match the analytic products;
  7. the batched product: product_batched over B = 4 device-resident sets
     of two 20,000-component 2-D densities (plan build, Gibbs, refit),
     set 0 against its standalone draw, then a refresh;
  8. label selection: samples/s of cdf, blocked and gumbel at the bench
     headline (B = 6 x [2 x 1000], 1000 chains, Niter 5), at B = 8, at
     phase 5's 2 x 50,000 with 256 chains and at phase 4's Gibbs stage
     (2 x 20,000, 20,000 chains);
  9. functionals, sampling, LOOCV refits and serialization on phase 4's
     densities: entropy, eval_avg_logl, kld and minkld against the same
     calls on the kernel's plain twin, kld against its analytic value, the
     unscented kld's 100,000-point LOOCV fit, sample moments, resample,
     the summaries, the overlap integral against its analytic value,
     nloo_ll/ksize in float64, string and npz round trips, which with no
     device= land on the card (the package's default device), as does
     kde() of NumPy points;
 10. manifold products at full width: a circular pair of 2 x 20,000
     components (`*` must land near pi; its hooked evaluation must not
     launch the kernel and matches float64 on the CPU), SE(2) 3-D beliefs
     of 2 x 20,000, and a hooked BatchedProductSampler over B = 4 circular
     sets, set 0 against its standalone draw;
 11. the distributed layer (kde_tpu_torch.parallel).  (a) In a one-rank
     NCCL world: the chain-sharded product of phase 4's densities
     (20,000 chains) and the kernel-sharded replay product of phase 5's
     (256 chains) against the unsharded engine (labels on >= 99.9 % of
     chains), product_sharded (its refit must launch the kernel),
     product_batched(mesh=) over 4 x [2 x 20,000] against the unsharded
     batch, sharded_log_eval at 20,000 x 20,000 (must launch the kernel),
     sharded_loo_entropy and ksize_bandwidths_sharded against their
     single-device calls, the same three and ksize_bandwidths_device on
     NumPy inputs (on the card, equal to the tensor calls),
     estimate_product_memory against the allocator's peak (ratio in
     [0.5, 2]), then scaling_bench.run at S = 1 (4,096 chains,
     2 x 1,000 components, Niter 5) and its comm_table.  (b) Two copies of this script
     (``--shared-card-worker``) share the card in a gloo world: the
     kernel-sharded product at S = 2 and the chain-sharded product over
     both ranks against the plain engine, and sharded_log_eval with the
     components split over both ranks (each rank must launch the kernel
     and keep the result on the card).  Launches made by the references
     that a sharded call is compared with are not counted;
 12. the eight examples_torch twins on the card at their own sizes, one
     line each (their checks raise; they stay below the kernel's gates).
Then one JSON line on the kernels, and last the device JSON line.  Any
failed check raises, so the script exits nonzero and prints no result.  It
refuses to run without a card.

    python3 chip_smoke.py --k1-parent DIR

times K1 only, against the K1 of the checkout in DIR (see k1_parent_ab).
"""

import contextlib
import functools
import importlib.util
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
BATCH_SETS = 4
SELECT_MODES = ("cdf", "blocked", "gumbel")
SELECT_REPS = 5
MEAN_TOL = 0.05          # product means vs their analytic values
RTOL = ATOL = 2e-4       # tests/test_pallas_eval.py: f32 sums in another order
N_UNSCENTED = 100_000    # kernel case (e): the unscented kld's LOO fit
N_OFFSET = 4096          # kernel case (f): data at 10^3
OFFSET_ATOL, OFFSET_RTOL = 1e-4, 1e-5   # (f) against float64, see phase 3
SFU_EX2_PER_CLK = 16     # per SM, compute capability 9.0
FP32_FLOPS = 67e12       # H100 SXM, outside the tensor cores
HBM_BYTES = 3.35e12      # H100 SXM
AGREE_MIN = 0.999        # sharded vs unsharded: share of chains that agree
N_LOO = 4096             # sharded LOO entropy
N_KSIZE = 8192           # sharded LOOCV bandwidths
KSIZE_RTOL = 1e-5        # sharded vs single-device bandwidths, float32
                         # (first set at 1e-3; the H100 read 0.0)
SHARED_CHAINS = 1024     # phase 11b kernel-sharded replay chains
WORKER_TIMEOUT = 300     # seconds: phase 11b workers, collectives
SCALING = dict(total_chains=4096, n_comp=1000, n_iter=5)   # kde_tpu's run()
FP64_FLOPS = 34e12       # H100 SXM, FP64 outside the tensor cores
SMALL_RTOL = 1e-9        # small-route selections (tests/test_host_small.py)
SMALL_ATOL = 1e-10       # small-route log p
SMALL_TOL = 1e-2         # the LOOCV search's tolerance (kde's default)
CFG1_FLOWS = 20          # README cfg 1 flows a timing round...
CFG1_ROUNDS = 6          # ...best of this many rounds (bench.py:239-244)
SMALL_GATES = ("HOST_LOOCV_LIMIT", "HOST_EVAL_LIMIT", "HOST_SAMPLE_LIMIT")
EXAMPLES = ("readme_examples", "evaluating_densities", "extracting_labels",
            "belief_propagation", "circular_fusion", "se2_fusion",
            "consensus_example", "profile_products")


def _sync():
    import torch
    torch.cuda.synchronize()


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def _cuda_ms(fn, reps=5, inner=1):
    """Milliseconds per call of ``fn()``: the median over ``reps`` windows
    of CUDA events, after one warm-up call.  With ``inner`` = 1 a window
    holds one call, the wrapper's host work included (the ``ms`` of the
    kernels line); with more it holds ``inner`` back-to-back calls and is
    divided by ``inner``, so each call's host work overlaps the previous
    call's kernel."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
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


def _sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    return float(out[0]) * 1e6


def k1_bound_ms(m, n, d, loo, sms, clock_hz):
    """The least time an H100 could take for one K1 call, and what sets it.
    Operations: one exp per (query, component) pair (the LOO diagonal
    excluded) at 16 ex2 per clock per SM (CUDA C++ Programming Guide,
    arithmetic instruction throughput, compute capability 9.0), and 4d + 3
    FP32 operations per pair at 67 TFLOP/s; bytes: each input read once and
    the output written once at 3.35 TB/s."""
    pairs = m * n - (m if loo else 0)
    times = {"operations": max(pairs / (SFU_EX2_PER_CLK * sms * clock_hz),
                               pairs * (4 * d + 3) / FP32_FLOPS),
             "bytes": 4 * (m * d + 2 * n * d + n + m) / HBM_BYTES}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def k1_inputs(rng, m, n, d, loo, dev):
    """K1's float32 inputs on ``dev``: queries, means, variances and
    normalized weights (with ``loo`` the queries are the means)."""
    import torch
    mu = rng.normal(size=(n, d))
    q = mu if loo else rng.normal(size=(m, d))
    var = rng.uniform(0.005, 0.05, size=(n, d))
    w = rng.uniform(0.1, 1.0, size=n)
    return [torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (q, mu, var, w / w.sum())]


def phase_kernel(dev):
    """Phase 3: kernel vs plain twin at the main path's shapes, timed at
    (a), (b) and (e) beside the bound and the dense route; (f) offset data
    against the float64 twin."""
    import torch
    from kde_tpu_torch.ops import kernels, tiled_eval
    rng = np.random.default_rng(SEED)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = _sm_clock_hz()

    def dense(q, mu, var, w, loo):
        exclude = torch.arange(len(q), device=dev) if loo else None
        return kernels.log_gauss_mixture(q, mu, var, torch.log(w),
                                         exclude=exclude)

    cases = {"a": (N_SLICE, N_SLICE, 2, False),
             "b": (N_SLICE, N_SLICE, 1, True),
             "c": (1000, 777, 3, False), "d": (1, 1, 1, True),
             "e": (N_UNSCENTED, N_UNSCENTED, 1, True)}
    rows, worst = {}, 0.0
    for name, (m, n, d, loo) in cases.items():
        args = k1_inputs(rng, m, n, d, loo, dev)
        got = tiled_eval.tiled_log_eval(*args, loo=loo)
        _sync()
        want = tiled_eval.tiled_log_eval_ref(*args, loo=loo)
        err = compare(got, want, f"case ({name})")
        worst = max(worst, err)
        row = {"M": m, "N": n, "d": d, "loo": loo, "max_abs_err": err}
        if name == "d" and not bool(torch.isneginf(got).all()):
            raise AssertionError("case (d): the all-masked row is not -inf")
        if name in ("a", "b", "e"):
            call = functools.partial(tiled_eval.tiled_log_eval, *args,
                                     loo=loo)
            row["ms"] = _cuda_ms(call)
            row["ms_back_to_back"] = _cuda_ms(call, inner=10)
            row["plain_ms"] = _cuda_ms(
                lambda: tiled_eval.tiled_log_eval_ref(*args, loo=loo))
            row["bound_ms"], row["bound_by"] = k1_bound_ms(m, n, d, loo, sms,
                                                         clock)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["plan"] = tiled_eval.launch_plan(m, n, d, sms)._asdict()
        if name in ("a", "b"):
            # no single PyTorch call computes this function; the dense
            # route (three cuBLAS products and torch.logsumexp) is context,
            # and the port never takes it above the size gate
            row["dense_ms"] = _cuda_ms(lambda: dense(*args, loo))
        rows[name] = row
        print(f"kernel ({name}): {json.dumps(row)}", flush=True)

    # (f) centers N(10^3, 1), bandwidth 10^-2, queries beside the centers,
    # against the float64 twin on the same float32 inputs.  A float32 ulp
    # at 10^3 is 6.1e-5: a q*s - mu*s form would lose ~1e-2 of each scaled
    # difference, but q - mu is exact here (Sterbenz), which leaves a few
    # ulp of the O(10) logits: atol 1e-4, rtol 1e-5.
    n = N_OFFSET
    mu = 1e3 + rng.normal(size=(n, 2))
    q = mu[rng.permutation(n)] + 0.01 * rng.normal(size=(n, 2))
    args = [torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (q, mu, np.full((n, 2), 1e-4), np.full(n, 1.0 / n))]
    got = tiled_eval.tiled_log_eval(*args).double()
    want = tiled_eval.tiled_log_eval_ref(*(x.double() for x in args))
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or bool(
            ((got - want).abs() > OFFSET_ATOL + OFFSET_RTOL * want.abs()).any()):
        raise AssertionError(f"case (f): max |err| {err} against float64 "
                             f"outside atol={OFFSET_ATOL}, rtol={OFFSET_RTOL}")
    rows["f"] = {"M": n, "N": n, "d": 2, "loo": False, "max_abs_err": err,
                 "vs": "float64 twin", "atol": OFFSET_ATOL, "rtol": OFFSET_RTOL}
    print(f"kernel (f): {json.dumps(rows['f'])}", flush=True)
    return rows, worst


def cfg1_points(seed):
    """README cfg 1 (bench.py:220): 50 + 50 bimodal points in 1-D and a
    200-point grid over their range."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=50), 10.0 + 2.0 * rng.normal(size=50)])
    return x, np.linspace(x.min(), x.max(), 200)


def _golden_inputs(name, dev):
    """Rows [R, N] and normalized weights [N], float64 on ``dev``."""
    import torch
    rng = np.random.default_rng(SEED + 11)
    if name == "cfg1":
        rows = cfg1_points(SEED)[0][None, :]
    elif name == "d2":                       # tests/test_host_small.py:20-33
        rows = (rng.normal(size=(120, 2)) * [1.0, 2.5]).T
    elif name == "gate_edge":
        rows = rng.normal(size=(1, 255))
    elif name == "zero_weights":             # tests/test_host_small.py:143
        x = np.concatenate([rng.normal(size=95) * 0.01, [500.0]])
        rows = np.concatenate([x, x + 1e-6])[None, :]
        w = np.concatenate([np.full(96, 1.0 / 96), np.zeros(96)])
    else:                                    # "n1", "n2": the guards
        rows = rng.normal(size=(1, int(name[1:])))
    if name != "zero_weights":
        w = np.full(rows.shape[1], 1.0 / rows.shape[1])
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                            device=dev) for a in (rows, w)]


def _eval_inputs(name, dev):
    """Queries [M, d] (the means for LOO), means and variances [N, d],
    weights [N], float64 on ``dev``; ``loo``."""
    import torch
    rng = np.random.default_rng(SEED + 12)
    loo = name.startswith("loo")
    if name == "cfg1":
        x, grid = cfg1_points(SEED)
        mu, q = x[:, None], grid[:, None]
        var = np.full_like(mu, 0.36)
    elif name == "widest":                   # 200 x 300 x 4 <= 2^18
        mu, q = rng.normal(size=(300, 4)), 1.5 * rng.normal(size=(200, 4))
        var = rng.uniform(0.05, 0.5, size=(300, 4))
    elif name == "exp_wrap":                 # tests/test_host_small.py:207
        mu = (np.arange(9) * 1e-6)[:, None]
        var = np.full((9, 1), 0.5)
        q = np.sqrt(np.concatenate([np.linspace(705.0, 715.0, 401),
                                    np.linspace(2125.0, 2135.0, 401)]))[:, None]
    else:                                    # "loo100", "loo255"
        n = int(name[3:])
        mu = q = rng.normal(size=(n, 1))
        var = np.full((n, 1), 0.1)
    w = np.ones(len(mu)) if name == "exp_wrap" else rng.uniform(0.5, 1.5,
                                                                len(mu))
    t = [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                         device=dev) for a in (q, mu, var, w / w.sum())]
    return t, loo


def _probes(args):
    """The probes of each row's golden search, counted on the twin (the
    kernel takes the same bracket steps)."""
    from kde_tpu_torch.ops import host_small
    counts, search = [], host_small._golden_scalar

    def counting(f, *a):
        seen = [0]

        def g(x):
            seen[0] += 1
            return f(x)
        out = search(g, *a)
        counts.append(seen[0])
        return out
    host_small._golden_scalar = counting
    try:
        host_small.loo_golden_ref(*args, SMALL_TOL)
    finally:
        host_small._golden_scalar = search
    return counts


def golden_bound_ms(rows, w, probes):
    """The least time an H100 could take for the searches, counting only
    the work the function needs: once per row, the shifted d2 of each live
    pair (i != j, w_i > 0, w_j > 0: difference, square, running minimum,
    shift); per probe, 4 FP64 operations per live pair (scale, exp counted
    as one, weight, add) and a log per live row; at 34 TFLOP/s.  Bytes:
    the rows, weights and brackets read once, the result written once, at
    3.35 TB/s."""
    r, n = rows.shape
    live = int((w > 0).sum())
    pairs = live * (live - 1)
    ops = sum(4 * pairs + p * (4 * pairs + live) for p in probes)
    times = {"operations": ops / FP64_FLOPS,
             "bytes": 8 * (r * n + n + 5 * r) / HBM_BYTES}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def eval_bound_ms(m, n, d, loo):
    """The least time for one small_log_eval, counting only the work the
    function needs: 4d + 4 FP64 operations per (query, component) pair
    (per dim difference, square, scale by 1/var, add; then the component's
    constant, exp, running maximum, add), the LOO diagonal excluded; 3d + 1
    per component (1/var, log var and its sum, log w) and 2 per query; each
    log and exp counted as one, at 34 TFLOP/s.  Bytes: inputs read once,
    the output written once, at 3.35 TB/s."""
    pairs = m * n - (m if loo else 0)
    ops = pairs * (4 * d + 4) + n * (3 * d + 1) + 2 * m
    times = {"operations": ops / FP64_FLOPS,
             "bytes": 8 * (m * d + 2 * n * d + n + m) / HBM_BYTES}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def _empty_launch(dev):
    """A call that launches small_ops.cu's empty kernel on ``dev``'s
    current stream through the same ctypes path as the two kernels: their
    timing floor.  Only this script uses that entry; the package does not."""
    import ctypes
    import torch
    from kde_tpu_torch.ops import host_small
    lib = host_small._load()
    lib.kde_empty_launch.argtypes = [ctypes.c_void_p]
    lib.kde_empty_launch.restype = ctypes.c_int
    stream = torch._C._cuda_getCurrentRawStream(
        torch.device(dev).index or torch.cuda.current_device())
    return lambda: host_small._checked("kde_empty_launch",
                                       lib.kde_empty_launch(stream))


def mixture_log_prob(q, mu, var, w):
    """``log sum_n w_n prod_k N(q_mk; mu_nk, var_nk)`` by one PyTorch call,
    torch.distributions' MixtureSameFamily of diagonal normals: the library
    time of small_log_eval (not LOO).  The port never calls it."""
    from torch.distributions import (Categorical, Independent,
                                     MixtureSameFamily, Normal)
    return MixtureSameFamily(
        Categorical(probs=w, validate_args=False),
        Independent(Normal(mu, var.sqrt(), validate_args=False), 1,
                    validate_args=False),
        validate_args=False).log_prob(q)


def phase_small(dev):
    """Phase 3b: the small-route kernels against their plain twins on the
    card, timed beside the twins, the parent's routes, an empty launch, the
    library call and the bounds.  Returns the rows printed and the worst
    error of each."""
    import torch
    from kde_tpu_torch.ops import host_small, kernels, loocv
    rows, worst = {}, {"loo_golden": 0.0, "small_log_eval": 0.0}
    empty_ms = _cuda_ms(_empty_launch(dev))
    for name in ("cfg1", "d2", "gate_edge", "zero_weights", "n1", "n2"):
        x, w = _golden_inputs(name, dev)
        base, ax, bx, cx = host_small._bracket(x)
        args = (x, w, base ** 2, ax, bx, cx)
        got = host_small.loo_golden(*args, SMALL_TOL) * base
        _sync()
        want = host_small.loo_golden_ref(*args, SMALL_TOL) * base
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs()).max())
        if not (bool(torch.isfinite(got).all()) and rel <= SMALL_RTOL):
            raise AssertionError(f"loo_golden ({name}): selection {got} "
                                 f"against the twin's {want}")
        worst["loo_golden"] = max(worst["loo_golden"], err)
        row = {"R": x.shape[0], "N": x.shape[1], "max_abs_err": err,
               "max_rel_err": rel}
        if name in ("cfg1", "d2", "gate_edge"):
            probes = _probes(args)
            row["probes"] = probes
            row["bound_ms"], row["bound_by"] = golden_bound_ms(x, w, probes)
            row["ms"] = _cuda_ms(lambda: host_small.loo_golden(*args,
                                                               SMALL_TOL))
            row["ksize_small_ms"] = _cuda_ms(
                lambda: host_small.ksize_small(x, w, SMALL_TOL))
            row["plain_ms"] = _cuda_ms(
                lambda: host_small.loo_golden_ref(*args, SMALL_TOL), reps=3)
            lo, hi = loocv._slices_on(x.shape[1], dev)
            for tag, dt in (("f32", torch.float32), ("f64", torch.float64)):
                xr, wr = x.to(dt), w.to(dt)
                row[f"parent_{tag}_ms"] = _cuda_ms(
                    lambda: loocv.ksize_rows(xr, wr, lo, hi, tol=SMALL_TOL),
                    reps=3)
            row["empty_ms"] = empty_ms
        rows[f"loo_golden {name}"] = row
        print(f"small loo_golden ({name}): {json.dumps(row)}", flush=True)

    for name in ("cfg1", "widest", "loo100", "loo255", "exp_wrap"):
        (q, mu, var, w), loo = _eval_inputs(name, dev)
        call = (functools.partial(host_small.log_eval_loo_small, mu, var, w)
                if loo else functools.partial(host_small.log_eval_small,
                                              q, mu, var, w))
        got = call()
        _sync()
        want = host_small.small_log_eval_ref(q, mu, var, w, loo)
        err = float((got - want).abs().max())
        if not (bool(torch.isfinite(got).all()) and err <= SMALL_ATOL):
            raise AssertionError(f"small_log_eval ({name}): max |err| {err} "
                                 f"against the twin, atol {SMALL_ATOL}")
        worst["small_log_eval"] = max(worst["small_log_eval"], err)
        m, d = q.shape
        row = {"M": m, "N": mu.shape[0], "d": d, "loo": loo,
               "max_abs_err": err}
        if name in ("cfg1", "widest"):
            row["bound_ms"], row["bound_by"] = eval_bound_ms(
                m, mu.shape[0], d, loo)
            row["ms"] = _cuda_ms(call)
            row["plain_ms"] = _cuda_ms(
                lambda: host_small.small_log_eval_ref(q, mu, var, w, loo))
            f32 = [t.float() for t in (q, mu, var, w)]
            row["parent_f32_ms"] = _cuda_ms(
                lambda: kernels.log_eval_gated(*f32))
            lib = mixture_log_prob(q, mu, var, w)
            row["library_err"] = float((lib - want).abs().max())
            if row["library_err"] > SMALL_ATOL:
                raise AssertionError(f"MixtureSameFamily ({name}): max |err| "
                                     f"{row['library_err']} against the twin")
            row["library_ms"] = _cuda_ms(
                lambda: mixture_log_prob(q, mu, var, w))
            row["empty_ms"] = empty_ms
        rows[f"small_log_eval {name}"] = row
        print(f"small small_log_eval ({name}): {json.dumps(row)}", flush=True)
    return rows, worst


def _cfg1_flow(x, grid, s, device=None):
    """README cfg 1 (bench.py:229-236) with the package's defaults:
    fit, evaluate, resample with a LOOCV refit, the LOO evaluation."""
    import kde_tpu_torch as kt
    p = kt.kde(x[None, :], device=device)
    v = p(grid)
    r = kt.resample(p, 75, "lcv", key=int(s))
    return p, v, r, p.evaluate(None, lv_flag=True)


def phase_cfg1(dev, seed=SEED):
    """Phase 3c: README cfg 1 end to end on the card, checked against the
    same flow on the CPU; then flows/s with the gates at their values and
    with the port's gates at 0 (the parent's routes), in turns."""
    import torch
    from kde_tpu_torch import config
    from kde_tpu_torch.ops import host_small
    sync = _sync if dev.type == "cuda" else (lambda: None)
    x, grid = cfg1_points(seed)
    before = dict(host_small.LAUNCHES)
    p, v, r, lv = _cfg1_flow(x, grid, seed)
    sync()
    for k, v2 in host_small.LAUNCHES.items():
        if v2 <= before[k] and dev.type == "cuda":
            raise AssertionError(f"README cfg 1 never launched {k}")
    c, vc, _, lvc = _cfg1_flow(x, grid, seed, device="cpu")
    bw_rel = float(np.max(np.abs(p.host_bw_std() / c.host_bw_std() - 1.0)))
    v_rel = float(((v.cpu() - vc).abs() / vc).max())
    lv_rel = float(((lv.cpu() - lvc).abs() / lvc).max())
    vv = v.cpu().numpy()
    mass = float(((vv[1:] + vv[:-1]) / 2 * np.diff(grid)).sum())
    if not (p.device.type == r.device.type == v.device.type == dev.type
            and v.dtype == lv.dtype == torch.float64
            and v.shape == (200,) and lv.shape == (100,) and r.npts == 75
            and bool(torch.isfinite(v).all() & (v >= 0).all())
            and bool(torch.isfinite(r.bw).all() & (r.bw > 0).all())
            and bw_rel <= SMALL_RTOL and v_rel <= 1e-12 and lv_rel <= 1e-12
            and 0.9 < mass < 1.01):
        raise AssertionError(f"README cfg 1 on the card: bandwidths "
                             f"{bw_rel}, p(grid) {v_rel}, LOO {lv_rel} from "
                             f"the CPU's; mass {mass}; {v.dtype} on "
                             f"{v.device}")

    def rate(gates_on):
        saved = {g: getattr(config, g) for g in SMALL_GATES}
        if not gates_on:
            for g in SMALL_GATES:
                setattr(config, g, 0)
        try:
            _cfg1_flow(x, grid, seed)
            best = float("inf")
            for rnd in range(CFG1_ROUNDS):
                sync()
                t0 = time.perf_counter()
                for i in range(CFG1_FLOWS):
                    _cfg1_flow(x, grid, seed + CFG1_FLOWS * rnd + i)
                sync()
                best = min(best, (time.perf_counter() - t0) / CFG1_FLOWS)
        finally:
            for g, val in saved.items():
                setattr(config, g, val)
        return 1.0 / best

    rates = {"gates": [], "gates_0": []}
    for on in (True, False, False, True):
        rates["gates" if on else "gates_0"].append(rate(on))
    return dict(bw=p.host_bw_std()[0, 0], bw_rel_vs_cpu=bw_rel,
                p_rel_vs_cpu=v_rel, loo_rel_vs_cpu=lv_rel, mass=mass,
                flows_per_s=rates)


def _timed(name, fn, sync, stages, launches):
    """``fn`` wrapped to add its seconds and kernel launches to
    ``stages[name]`` and ``launches[name]``."""
    from kde_tpu_torch.ops import tiled_eval

    def wrapper(*args, **kw):
        sync()
        t0, l0 = time.perf_counter(), tiled_eval.LAUNCHES
        out = fn(*args, **kw)
        sync()
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
        launches[name] = launches.get(name, 0) + tiled_eval.LAUNCHES - l0
        return out
    return wrapper


def _timed_product(run, sync, stages, launches, prefix="", where=None):
    """``run()`` a `*` product, which draws the Gibbs chains and then refits
    the samples with ``kde`` of module ``where`` (default ``ops.gibbs``):
    that call is wrapped to split the two stages' times and launches."""
    from kde_tpu_torch.ops import gibbs, tiled_eval
    where = where or gibbs
    refit = where.kde
    where.kde = _timed(prefix + "refit", refit, sync, stages, launches)
    try:
        sync()
        t0, l0 = time.perf_counter(), tiled_eval.LAUNCHES
        out = run()
    finally:
        where.kde = refit
    stages[prefix + "gibbs"] = (time.perf_counter() - t0
                                - stages[prefix + "refit"])
    launches[prefix + "gibbs"] = (tiled_eval.LAUNCHES - l0
                                  - launches[prefix + "refit"])
    return out


def _check_mean(k, want, what, n):
    """The sample mean of KDE ``k``'s points is within MEAN_TOL of ``want``
    in every dim (the bound widens only for a small rehearsal on the CPU)."""
    mean = k.points.double().mean(dim=0).cpu().numpy()
    if not np.all(np.abs(mean - want) < max(MEAN_TOL, 4.0 / np.sqrt(n))):
        raise AssertionError(f"{what}: mean {mean} not near {want}")
    return mean.tolist()


def phase_slice(dev, n=N_SLICE, seed=SEED):
    """Phase 4: the `*` slice; returns per-stage seconds and launches."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch import native
    from kde_tpu_torch.ops import balltree, kernels, tiled_eval
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
    # on the densities, so `p * q` below reuses them): built natively
    b0, t0 = native.BUILDS, time.perf_counter()
    p.tree, q.tree
    stages["trees_native"] = time.perf_counter() - t0
    if native.BUILDS != b0 + 2:
        raise AssertionError(f"the trees stage made {native.BUILDS - b0} "
                             "native builds, not 2")
    # p's tree once more with the NumPy builder, the native one's twin
    t0 = time.perf_counter()
    twin = balltree.build_balltree(p.host_points().T, p.host_weights(),
                                   p._host_var()[0], backend="python")
    stages["trees_python"] = time.perf_counter() - t0
    for f in TREE_FIELDS:
        if not np.array_equal(getattr(p.tree, f), getattr(twin, f)):
            raise AssertionError(f"native tree field {f} differs from the "
                                 "NumPy builder's")

    kt.set_seed(seed)
    pq = _timed_product(lambda: p * q, sync, stages, launches)

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
                eval_err_vs_f64=err), (p, q)


TREE_FIELDS = ("centers", "ranges", "weights", "means", "bandwidth", "left",
               "right", "lowest_leaf", "highest_leaf", "permutation",
               "depth", "bw_min", "bw_max")


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
                samples_per_s=SERVE_CALLS * SERVE_CHAINS / dt), sampler


def phase_device_plan(dev, p, q, seed=SEED):
    """Phase 6: `*` over device-resident copies of phase 4's densities,
    which takes the device-built plan; then the chained product."""
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import gibbs
    sync = _sync if dev.type == "cuda" else (lambda: None)
    p2, q2 = (kt.KDE(k.points, k.bw, k.weights) for k in (p, q))
    n = p2.npts
    stages, launches = {}, {}
    # the plans are cached on the densities: the products below reuse them
    build = lambda name, dens: _timed(name, gibbs._get_plan, sync, stages,
                                      launches)(dens, n, p2.dtype, dev,
                                                "device")
    build("plan", [p2, q2])
    kt.set_seed(seed)
    pq = _timed_product(lambda: p2 * q2, sync, stages, launches)
    build("chained_plan", [pq, q2])
    pqq = _timed_product(lambda: pq * q2, sync, stages, launches, "chained_")
    if any(k._tree is not None for k in (p2, q2, pq)):
        raise AssertionError("the device-plan path built a host tree")
    for stage in ("refit", "chained_refit"):
        if launches[stage] < 1 and dev.type == "cuda":
            raise AssertionError(f"stage {stage} never launched the kernel")
    # N(0, I) x N(0.5, I) = N(0.25, I/2); N(0.25, I/2) x N(0.5, I) has mean
    # (2 * 0.25 + 0.5) / 3 = 1/3
    return dict(seconds=stages, launches=launches,
                mean=_check_mean(pq, 0.25, "p' * q'", n),
                chained_mean=_check_mean(pqq, 1.0 / 3.0, "(p'q') * q'", n))


def phase_batched(dev, n=N_SLICE, b=BATCH_SETS, seed=SEED):
    """Phase 7: product_batched over ``b`` device-resident sets of two
    ``n``-component 2-D densities N(m, I) and N(m + 0.5, I), m = 0.25 i;
    then set 0 against its standalone draw, and a refresh."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import gibbs
    from kde_tpu_torch.utils.random import split
    rng = np.random.default_rng(seed + 3)
    sync = _sync if dev.type == "cuda" else (lambda: None)
    bw = [1.06 * n ** -0.2]

    def make_sets():
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        return [[kt.kde(f32(rng.normal(size=(2, n)) + 0.25 * i), bw),
                 kt.kde(f32(rng.normal(size=(2, n)) + 0.25 * i + 0.5), bw)]
                for i in range(b)]

    sets = make_sets()
    stages, launches = {}, {}
    saved = gibbs.batched_device_plans, gibbs.ksize_rows
    gibbs.batched_device_plans = _timed("plan", saved[0], sync, stages,
                                        launches)
    gibbs.ksize_rows = _timed("refit", saved[1], sync, stages, launches)
    try:
        sync()
        t0 = time.perf_counter()
        outs = kt.product_batched(sets, key=seed)
        sync()
        total = time.perf_counter() - t0
    finally:
        gibbs.batched_device_plans, gibbs.ksize_rows = saved
    stages["gibbs"] = total - stages["plan"] - stages["refit"]
    if launches["refit"] < 1 and dev.type == "cuda":
        raise AssertionError("the batched refit never launched the kernel")
    if len(outs) != b or any(k.npts != n or k.device != sets[0][0].device
                             for k in outs):
        raise AssertionError("product_batched: wrong count, size or device")
    means = [_check_mean(k, 0.25 * i + 0.25, f"batched set {i}", n)
             for i, k in enumerate(outs)]

    # set 0 against a standalone product keyed by split(key, b)[0], with
    # the selection the batch resolves to
    sampler = kt.BatchedProductSampler(sets, n_out=n, n_iter=5)
    own = gibbs._get_plan(sets[0], n, sets[0][0].dtype, dev, "device")
    plan_equal = all(torch.equal(getattr(sampler.plans, f)[0],
                                 getattr(own, f))
                     for f in gibbs._PLAN_TENSORS)
    if not plan_equal:
        raise AssertionError("set 0's plan built in the batch differs from "
                             "its own")
    select = gibbs.resolve_select("auto", n, sampler.plans.offsets[-1][1],
                                  batch=b)
    pts, idx = sampler.sample(seed, select=select)
    pts0, idx0 = kt.prod_appx_ms_gibbs(n, sets[0], n_iter=5,
                                       key=split(seed, b)[0], select=select)
    same = (idx[0] == idx0).all(dim=0)
    mismatches = int((~same).sum())
    diff = float((pts[0] - pts0)[:, same].abs().max())
    if mismatches > 1e-3 * n or diff > 1e-5:
        raise AssertionError(f"batched set 0 vs standalone: {mismatches} of "
                             f"{n} chains differ, max |dx| {diff}")
    sampler.refresh(make_sets())
    again, _ = sampler.sample(seed + 1)
    sync()
    if again.shape != (b, 2, n) or not bool(torch.isfinite(again).all()):
        raise AssertionError("refresh: wrong shape or non-finite sample")
    return dict(seconds=stages, launches=launches, means=means,
                select=select, set0_label_mismatches=mismatches,
                set0_max_abs_dx=diff)


def phase_select(dev, serve, slice_dens, n_comp=1000, n_out=1000,
                 seed=SEED):
    """Phase 8: samples/s of each selection mode at the bench headline
    (B = 6 sets of [2 x n_comp], bw 0.1, n_out chains, Niter 5), at B = 8,
    on phase 5's sampler, and on the Gibbs stage of phase 4's `*` (its two
    densities, as many chains as components); the median of SELECT_REPS
    calls after a warm-up, the modes taken in turns."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import gibbs
    rng = np.random.default_rng(seed + 4)
    sync = _sync if dev.type == "cuda" else (lambda: None)
    dens = [kt.kde((rng.normal(size=(2, n_comp)) + s).astype(np.float32),
                   [0.1], device=dev, dtype=torch.float32) for s in (0.0, 0.5)]
    cells = {f"B=6 2x{n_comp}": (kt.BatchedProductSampler(
                 [dens] * 6, n_out=n_out, n_iter=5), 6, n_out),
             f"B=8 2x{n_comp}": (kt.BatchedProductSampler(
                 [dens] * 8, n_out=n_out, n_iter=5), 8, n_out),
             f"B=1 2x{serve.densities[0].npts}":
                 (serve, 1, serve.n_out),
             f"B=1 2x{slice_dens[0].npts} `*`": (kt.ProductSampler(
                 slice_dens, n_out=slice_dens[0].npts, n_iter=5), 1,
                 slice_dens[0].npts)}
    rows = {}
    for cell, (sampler, b, chains) in cells.items():
        width = sampler.plans.offsets[-1][1]
        for mode in SELECT_MODES:
            sampler.sample(seed, select=mode)
        sync()
        times = {m: [] for m in SELECT_MODES}
        for r in range(SELECT_REPS):
            for mode in SELECT_MODES:
                sync()
                t0 = time.perf_counter()
                out = sampler.sample(seed + 1 + r, select=mode)[0]
                sync()
                times[mode].append(time.perf_counter() - t0)
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"{cell} {mode}: non-finite sample")
        rate = {m: b * chains / float(np.median(t)) for m, t in times.items()}
        rows[cell] = dict(samples_per_s=rate, width=width, chains=chains,
                          sets=b, winner=max(rate, key=rate.get),
                          auto=gibbs.resolve_select("auto", chains, width,
                                                    batch=b))
        print(f"select {cell}: {json.dumps(rows[cell])}", flush=True)
    return rows


@contextlib.contextmanager
def _on_twin():
    """Every above-gate evaluation on the kernel's plain twin instead of
    the kernel (ops/kernels.py launches it through this one name)."""
    from kde_tpu_torch.ops import kernels, tiled_eval
    saved = kernels.tiled_log_eval
    kernels.tiled_log_eval = tiled_eval.tiled_log_eval_ref
    try:
        yield
    finally:
        kernels.tiled_log_eval = saved


def _launched(launches, names, dev):
    for name in names:
        if launches[name] < 1 and dev.type == "cuda":
            raise AssertionError(f"stage {name} never launched the kernel")


def _on_device(k, dev, dtype, what):
    if k.device.type != dev.type or k.dtype != dtype:
        raise AssertionError(f"{what}: on {k.device} in {k.dtype}, not on "
                             f"{dev.type} in {dtype}")


def phase_functionals(dev, p, q, seed=SEED):
    """Phase 9: functionals, sampling, LOOCV refits and serialization on
    phase 4's tensor-backed densities p ~ N(0, I) and q ~ N(0.5, I)."""
    import tempfile
    import torch
    import kde_tpu_torch as kt
    sync = _sync if dev.type == "cuda" else (lambda: None)
    stages, launches, vals, errs = {}, {}, {}, {}

    def stage(name, fn, *args, **kw):
        return _timed(name, fn, sync, stages, launches)(*args, **kw)

    n, f32 = p.npts, torch.float32
    slack = 4.0 / np.sqrt(n)    # widens the bounds only for a CPU rehearsal
    for name, fn, args in (("entropy", kt.entropy, (p,)),
                           ("eval_avg_logl", kt.eval_avg_logl, (p, q)),
                           ("kld", kt.kld, (p, q)),
                           ("minkld", kt.minkld, (p, q))):
        got = stage(name, fn, *args)
        with _on_twin():
            want = fn(*args)
        errs[name] = compare(got.reshape(1), want.reshape(1),
                             f"{name} vs twin")
        vals[name] = float(got)
    # KL(N(0, sI) || N(0.5, sI)) in 2-D is 0.25 / s, s = 1 + h^2
    h2 = float(p.bw[0].double().mean())
    vals["kld_analytic"] = 0.25 / (1.0 + h2)
    if abs(vals["kld"] - vals["kld_analytic"]) > 0.05 + slack:
        raise AssertionError(f"kld {vals['kld']} not near "
                             f"{vals['kld_analytic']}")
    vals["kld_unscented"] = float(stage("kld_unscented", kt.kld, p, q,
                                        "unscented"))
    if not np.isfinite(vals["kld_unscented"]):
        raise AssertionError("unscented kld is not finite")

    pts, ind = stage("sample", kt.sample, p, n, seed)
    x, mu = pts.double(), p.points.double()
    want_var = mu.var(dim=0, unbiased=False) + p.bw[0].double()
    vals["sample_mean"] = x.mean(dim=1).tolist()
    vals["sample_var"] = x.var(dim=1, unbiased=False).tolist()
    if not (bool(((x.mean(dim=1) - mu.mean(dim=0)).abs() < 0.05 + slack)
                 .all())
            and bool(((x.var(dim=1, unbiased=False) - want_var).abs()
                      < 0.05 + slack).all())):
        raise AssertionError(f"sample moments {vals['sample_mean']}, "
                             f"{vals['sample_var']} not near p's")
    for mode in ("lcv", "discrete"):
        r = stage(f"resample_{mode}", kt.resample, p, None, mode, seed)
        _on_device(r, dev, f32, f"resample {mode}")
        if r.npts != n or not bool(torch.isfinite(r.bw).all()):
            raise AssertionError(f"resample {mode}: wrong size or bandwidth")

    for name in ("get_kde_range", "get_kde_range_linspace", "get_kde_max",
                 "get_kde_mean", "get_kde_fit"):
        out = stage(name, getattr(kt, name), p)
        for t in (out if isinstance(out, tuple) else (out,)):
            if t.device.type != dev.type or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name}: off the device or non-finite")
        vals[name] = (out[0] if isinstance(out, tuple) else out).tolist()
    vals["get_kde_range_linspace"] = vals["get_kde_range_linspace"][::50]
    if not all(abs(v) < 0.3 + slack for v in vals["get_kde_max"]):
        raise AssertionError(f"get_kde_max {vals['get_kde_max']} not near 0")

    # the overlap of two Gaussians N(m_p, S_p), N(m_q, S_q) is
    # N(m_p - m_q; 0, S_p + S_q), S the mixture covariance
    ov = float(stage("inters_intg_appx_is", kt.inters_intg_appx_is, p, q,
                     201))
    cov = lambda k: (np.cov(k.points.double().cpu().numpy().T, bias=True)
                     + np.diag(k.bw[0].double().cpu().numpy()))
    s = cov(p) + cov(q)
    delta = (p.points.double().mean(dim=0)
             - q.points.double().mean(dim=0)).cpu().numpy()
    want = float(np.exp(-0.5 * delta @ np.linalg.solve(s, delta))
                 / (2 * np.pi * np.sqrt(np.linalg.det(s))))
    vals["overlap"], vals["overlap_analytic"] = ov, want
    if abs(ov / want - 1.0) > 0.05 + slack:
        raise AssertionError(f"overlap {ov} not within 5% of {want}")

    vals["nloo_ll"] = stage("nloo_ll", kt.nloo_ll, 1.0, p)
    if abs(vals["nloo_ll"] / vals["entropy"] - 1.0) > 1e-3:
        raise AssertionError(f"nloo_ll {vals['nloo_ll']} != entropy "
                             f"{vals['entropy']}")
    k = stage("ksize", kt.ksize, p)
    _on_device(k, dev, f32, "ksize")
    rel = float(((k.bw[0] / p.bw[0]).sqrt() - 1.0).abs().max())
    if rel > 3e-2:
        raise AssertionError(f"float64 ksize bandwidths {rel:.3g} from the "
                             "float32 fit's")

    # NumPy, string and file inputs with no device= land on the package's
    # default device (config.DEVICE: the card)
    s = stage("to_string", kt.to_string, p)
    back = stage("from_string", kt.from_string, s, dtype=f32)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "p.npz")
        stage("save_kde", kt.save_kde, path, p)
        loaded = stage("load_kde", kt.load_kde, path)
    from_np = kt.kde(np.random.default_rng(seed + 6).normal(size=(2, 1000)),
                     dtype=f32)
    _on_device(from_np, dev, f32, "kde(NumPy points) with no device")
    for what, r in (("from_string", back), ("load_kde", loaded)):
        _on_device(r, dev, f32, what)
        if not torch.equal(r.points, p.points):
            raise AssertionError(f"{what} did not restore p's points")
    if not (torch.equal(loaded.bw, p.bw)
            and torch.equal(loaded.weights, p.weights)):
        raise AssertionError("load_kde did not restore p's bandwidths")
    _launched(launches, ("entropy", "eval_avg_logl", "kld", "minkld",
                         "kld_unscented", "resample_lcv"), dev)
    return dict(seconds=stages, launches=launches, values=vals,
                twin_err=errs, ksize_rel=rel)


def _hook_kw(kinds):
    """The hook quadruple for per-dim ``kinds``, ``e`` Euclidean and ``c``
    circular."""
    from kde_tpu_torch import manifolds as m
    pick = lambda e, c: tuple(e if k == "e" else c for k in kinds)
    return dict(addop=pick(m.euclid_add, m.circular_add),
                diffop=pick(m.euclid_diff, m.circular_diff),
                get_mu=pick(m.euclid_mu, m.circular_mu),
                get_lambda=pick(m.euclid_lambda, m.circular_lambda))


def _wrap(a):
    return a - 2 * np.pi * np.round(a / (2 * np.pi))


def _check_near_pi(x, what):
    """Median distance to pi under 0.5 and under 20 % of the mass within
    1 of 0 (the thresholds of tests/test_manifolds.py:81-83)."""
    x = x.double().cpu().numpy()
    med, near0 = (float(np.median(np.abs(_wrap(x - np.pi)))),
                  float(np.mean(np.abs(x) < 1.0)))
    if not (med < 0.5 and near0 < 0.2):
        raise AssertionError(f"{what}: median distance to pi {med}, "
                             f"{near0} of the mass near 0")
    return med, near0


def phase_manifolds(dev, n=N_SLICE, b=BATCH_SETS, seed=SEED):
    """Phase 10: circular and SE(2) products at full width, and a hooked
    batched product."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import gibbs, kernels
    from kde_tpu_torch.utils.random import split
    rng = np.random.default_rng(seed + 5)
    sync = _sync if dev.type == "cuda" else (lambda: None)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    circ, se2 = _hook_kw("c"), _hook_kw("eec")
    stages, launches, out = {}, {}, {}

    def circ_pair(shift=0.0):
        """The pair of tests/test_manifolds.py:67-70, either side of pi."""
        a = _wrap(np.pi - 0.2 + shift + 0.05 * rng.normal(size=(1, n)))
        b = _wrap(-np.pi + 0.2 + shift + 0.05 * rng.normal(size=(1, n)))
        return [kt.kde(f32(x), [0.1], **circ) for x in (a, b)]

    pa, pb = circ_pair()
    kt.set_seed(seed)
    pq = _timed_product(lambda: pa * pb, sync, stages, launches)
    out["circular"] = _check_near_pi(pq.points[:, 0], "circular `*`")
    if pq.get_mu[0] is not circ["get_mu"][0]:
        raise AssertionError("circular `*` lost its hooks")
    queries = f32(_wrap(np.pi + 0.3 * rng.normal(size=(1, n))))
    lp = _timed("hooked_evaluate", pq.log_eval, sync, stages,
                launches)(queries)
    if launches["hooked_evaluate"] != 0:
        raise AssertionError("hooked evaluation launched the kernel")
    m_ref = min(n, 1000)
    ref = kernels.log_eval(queries[:, :m_ref].T.double().cpu(),
                           pq.points.double().cpu(), pq.bw.double().cpu(),
                           pq.weights.double().cpu(), pq._eval_diffop,
                           chunk=max(1, (1 << 22) // n))
    out["hooked_eval_err_vs_f64"] = compare(lp[:m_ref].cpu(), ref.float(),
                                            "hooked evaluate vs float64")

    def belief(x, y, theta):
        pts = np.vstack([x + 0.15 * rng.normal(size=n),
                         y + 0.15 * rng.normal(size=n),
                         _wrap(theta + 0.05 * rng.normal(size=n))])
        return kt.kde(f32(pts), [0.08, 0.08, 0.05], **se2)

    sa, sb = belief(2.0, 1.0, np.pi - 0.15), belief(2.3, 0.8, -np.pi + 0.15)
    fused = _timed_product(lambda: sa * sb, sync, stages, launches, "se2_")
    xy = fused.points[:, :2].double().mean(dim=0).cpu().numpy()
    at_wrap = float((fused.points[:, 2].abs() > np.pi / 2).double().mean())
    out["se2_xy"], out["se2_at_wrap"] = xy.tolist(), at_wrap
    if not (np.all(np.abs(xy - [2.15, 0.9]) < 0.2) and at_wrap > 0.9):
        raise AssertionError(f"SE(2) fusion: position {xy}, {at_wrap} of "
                             "the heading mass at the wrap")

    sets = [circ_pair(0.05 * i) for i in range(b)]
    sampler = kt.BatchedProductSampler(sets, n_out=n, n_iter=5)
    select = gibbs.resolve_select("auto", n, sampler.plans.offsets[-1][1],
                                  batch=b)
    pts, idx = _timed("batched_gibbs", sampler.sample, sync, stages,
                      launches)(seed, select=select)
    pts0, idx0 = kt.ProductSampler(sets[0], n_out=n, n_iter=5).sample(
        split(seed, b)[0], select=select)
    same = (idx[0] == idx0).all(dim=0)
    mismatches = int((~same).sum())
    diff = float((pts[0] - pts0)[:, same].abs().max())
    if mismatches > 1e-3 * n or diff > 1e-5:
        raise AssertionError(f"hooked batched set 0 vs standalone: "
                             f"{mismatches} of {n} chains differ, max |dx| "
                             f"{diff}")
    for i in range(b):
        _check_near_pi(pts[i, 0] - 0.05 * i, f"hooked batched set {i}")
    out.update(select=select, set0_label_mismatches=mismatches,
               set0_max_abs_dx=diff)
    _launched(launches, ("refit", "se2_refit"), dev)
    return dict(seconds=stages, launches=launches, **out)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _agree(idx, want, what):
    """Share of chains whose labels all agree; raises under AGREE_MIN."""
    share = float((idx == want).all(dim=0).double().mean())
    if share < AGREE_MIN:
        raise AssertionError(f"{what}: labels agree on {share:.5f} of the "
                             f"chains, under {AGREE_MIN}")
    return share


def _host_ms(fn, sync, reps=3):
    """Median host milliseconds of ``fn()`` ending in a sync, after one
    warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _replay_streams(rng, n_out, dens, n_iter):
    from kde_tpu_torch.ops import balltree, gibbs
    L = balltree.n_levels(n_out, [k.npts for k in dens])
    bu, bn = gibbs._stream_sizes(len(dens), dens[0].ndim, L, n_iter)
    return (rng.uniform(size=n_out * bu).astype(np.float32),
            rng.normal(size=n_out * bn).astype(np.float32))


@contextlib.contextmanager
def _uncounted():
    """Kernel launches inside the block belong to a reference that the
    path is compared with, not to the path: the count is put back after
    it."""
    from kde_tpu_torch.ops import tiled_eval
    n = tiled_eval.LAUNCHES
    try:
        yield
    finally:
        tiled_eval.LAUNCHES = n


def phase_parallel(dev, p, q, serve, b=BATCH_SETS, seed=SEED):
    """Phase 11a: the sharded entry points in a one-rank NCCL world, each
    against its unsharded counterpart at full width.  The references'
    kernel launches stay out of the path's count."""
    import torch
    import torch.distributed as dist
    import kde_tpu_torch as kt
    from kde_tpu_torch import parallel as par
    from kde_tpu_torch.ops import kernels, loocv
    from kde_tpu_torch.parallel import product as par_product
    stages, launches, out = {}, {}, {}

    def stage(name, fn, *args, **kw):
        return _timed(name, fn, _sync, stages, launches)(*args, **kw)

    def reference(name, fn, *args, **kw):
        with _uncounted():
            return stage(name, fn, *args, **kw)

    par.initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                             backend="nccl", timeout=WORKER_TIMEOUT)
    try:
        mesh, mesh2 = par.make_mesh(), par.make_mesh_2d((1, 1))
        n = p.npts
        # chain-sharded product against the unsharded keyed call, timed
        # in turns (sharded, plain, plain, sharded)
        calls = {"chain_sharded": lambda: par.prod_appx_ms_gibbs_sharded(
                     mesh, n, [p, q], n_iter=5, key=seed),
                 "chain_plain": lambda: kt.prod_appx_ms_gibbs(
                     n, [p, q], n_iter=5, key=seed, select="cdf")}
        idx = {}
        for name in ("chain_sharded", "chain_plain", "chain_plain",
                     "chain_sharded"):
            call = reference if name == "chain_plain" else stage
            idx[name] = call(name, calls[name])[1]
        out["chain_agree"] = _agree(idx["chain_sharded"], idx["chain_plain"],
                                    "chain-sharded")
        # sharded `*`: the refit launches K1, the result stays on the card
        pq = _timed_product(
            lambda: par.product_sharded(mesh, [p, q], key=seed), _sync,
            stages, launches, "sharded_", where=par_product)
        out["sharded_mean"] = _check_mean(pq, 0.25, "product_sharded", n)
        if pq._host_points is not None or pq._tree is not None \
                or pq.device.type != dev.type:
            raise AssertionError("product_sharded left the device")

        # kernel-sharded replay (S = 1) against the plain engine
        dens = serve.densities
        ru, rn = _replay_streams(np.random.default_rng(seed + 11),
                                 SERVE_CHAINS, dens, 5)
        ks = lambda: par.prod_appx_ms_gibbs_kernel_sharded(
            mesh2, SERVE_CHAINS, dens, n_iter=5, rand_u=ru, rand_n=rn)
        plain = lambda: kt.prod_appx_ms_gibbs(SERVE_CHAINS, dens, n_iter=5,
                                              rand_u=ru, rand_n=rn)
        with _uncounted():
            want = plain()[1]
        out["kernel_agree"] = _agree(ks()[1], want, "kernel-sharded")
        out["kernel_sharded_ms"] = _host_ms(ks, _sync)
        with _uncounted():
            out["kernel_plain_ms"] = _host_ms(plain, _sync)
        out["kernel_s1_overhead"] = (out["kernel_sharded_ms"]
                                     / out["kernel_plain_ms"])

        # set-sharded batch against the unsharded batch
        rng = np.random.default_rng(seed + 3)
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        bw = [1.06 * n ** -0.2]
        sets = [[kt.kde(f32(rng.normal(size=(2, n)) + 0.25 * i), bw),
                 kt.kde(f32(rng.normal(size=(2, n)) + 0.25 * i + 0.5), bw)]
                for i in range(b)]
        got = stage("batched_sharded", kt.product_batched, sets, key=seed,
                    mesh=mesh)
        want = reference("batched_plain", kt.product_batched, sets,
                         key=seed)
        agree, bw_rel = [], 0.0
        for g, w in zip(got, want):
            agree.append(float(((g.points - w.points).abs() <= 1e-5)
                               .all(dim=1).double().mean()))
            bw_rel = max(bw_rel, float(((g.bw[0] - w.bw[0]).abs()
                                        / w.bw[0]).max()))
        out["batched_agree"], out["batched_bw_rel"] = agree, bw_rel
        if min(agree) < AGREE_MIN or bw_rel > 1e-5:
            raise AssertionError(f"set-sharded batch: chains agree {agree}, "
                                 f"bandwidths {bw_rel} apart")

        # sharded evaluation and LOOCV against the single-device calls
        qs = f32(np.random.default_rng(seed + 12).normal(size=(n, 2)))
        lp = stage("sharded_log_eval", par.sharded_log_eval, mesh2, qs,
                   pq.points, pq.bw, pq.weights)
        if not lp.is_cuda:
            raise AssertionError("sharded_log_eval left the card")
        with _uncounted():
            want = kernels.log_eval_gated(qs, pq.points, pq.bw, pq.weights)
        out["log_eval_err"] = compare(lp, want, "sharded_log_eval")
        pts, var = pq.points[:N_LOO].contiguous(), pq.bw[:N_LOO].contiguous()
        w = torch.full((len(pts),), 1.0 / len(pts), dtype=pts.dtype,
                       device=dev)
        h = stage("sharded_loo_entropy", par.sharded_loo_entropy, mesh2,
                  pts, var, w)
        with _uncounted():
            want = kernels.entropy_kernel(pts, var, w)
        out["loo_rel"] = abs(float(h) / float(want) - 1.0)
        pts = pq.points[:N_KSIZE].contiguous()
        bws = stage("ksize_sharded", par.ksize_bandwidths_sharded, mesh2,
                    pts)
        with _uncounted():
            ksize_dev = loocv.ksize_bandwidths_device(pts)
        out["ksize_rel"] = float(((bws - ksize_dev).abs() / ksize_dev).max())
        if out["loo_rel"] > RTOL or out["ksize_rel"] > KSIZE_RTOL:
            raise AssertionError(f"sharded LOOCV: entropy {out['loo_rel']}, "
                                 f"bandwidths {out['ksize_rel']} apart")
        # NumPy inputs land on the card (config.DEVICE) and give the
        # tensor calls' results
        for name, fn, args, ref in (
                ("sharded_log_eval_numpy",
                 functools.partial(par.sharded_log_eval, mesh2),
                 (qs, pq.points, pq.bw, pq.weights), lp),
                ("sharded_loo_entropy_numpy",
                 functools.partial(par.sharded_loo_entropy, mesh2),
                 (pq.points[:N_LOO], pq.bw[:N_LOO], w), h),
                ("ksize_sharded_numpy",
                 functools.partial(par.ksize_bandwidths_sharded, mesh2),
                 (pts,), bws),
                ("ksize_device_numpy", loocv.ksize_bandwidths_device,
                 (pts,), ksize_dev)):
            got = stage(name, fn, *(a.cpu().numpy() for a in args))
            if not (got.is_cuda and torch.equal(got, ref)):
                raise AssertionError(
                    f"{name}: on {got.device}, max |NumPy - tensor call| "
                    f"{float((got.cpu() - ref.cpu()).abs().max())}")
        out["numpy_inputs_on_card"] = True
        with _uncounted():
            out["sizing"] = _sizing(dev, [(serve.densities, SERVE_CHAINS),
                                          ([p, q], n)], seed)
        _launched(launches, ("sharded_refit", "batched_sharded",
                             "sharded_log_eval", "sharded_log_eval_numpy"),
                  dev)
    finally:
        dist.destroy_process_group()
    out["scaling"] = phase_scaling()
    return dict(seconds=stages, launches=launches, **out)


def phase_scaling():
    """Phase 11a's last step: scaling_bench.run at S = 1 (a one-rank NCCL
    world in a child process) with kde_tpu's run() defaults."""
    from kde_tpu_torch.parallel import scaling_bench
    t0 = time.perf_counter()
    res = scaling_bench.run(sizes=(1,), timeout=WORKER_TIMEOUT, **SCALING)
    rate = res["strong_scaling"][0]["samples_per_s"]
    if not (np.isfinite(rate) and rate > 0):
        raise AssertionError(f"scaling_bench S = 1: rate {rate}")
    return dict(seconds=time.perf_counter() - t0, config=res["config"],
                samples_per_s=rate,
                weak_samples_per_s=res["weak_scaling"][0]["samples_per_s"],
                comm_table=res["kernel_sharded_comm"])


def phase_examples(dev):
    """Phase 12: the examples_torch twins on the card at their own sizes,
    their output captured; one line each with the seconds and the twin's
    summary."""
    import importlib
    import io
    sync = _sync if dev.type == "cuda" else (lambda: None)
    rows = {}
    for name in EXAMPLES:
        mod = importlib.import_module(f"examples_torch.{name}")
        buf = io.StringIO()
        sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = mod.main(device=dev)
        sync()
        rows[name] = dict(seconds=time.perf_counter() - t0,
                          summary={k: v for k, v in res.items()
                                   if not isinstance(v, np.ndarray)},
                          last_line=buf.getvalue().strip().splitlines()[-1])
        print(f"example {name}: {json.dumps(rows[name])}", flush=True)
    return rows


def _sizing(dev, cases, seed):
    """estimate_product_memory against the allocator's peak over the keyed
    product of device-resident copies (a fresh plan, built in the
    window)."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch.parallel import estimate_product_memory
    rows = {}
    for dens, n_out in cases:
        copies = [kt.KDE(k.points, k.bw, k.weights) for k in dens]
        _sync()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        kt.prod_appx_ms_gibbs(n_out, copies, n_iter=5, key=seed)
        _sync()
        peak = torch.cuda.max_memory_allocated(dev) - base
        est = estimate_product_memory(copies, n_out, n_iter=5,
                                      dtype=torch.float32)
        ratio = est["total"] / peak
        rows[f"2x{dens[0].npts}/{n_out}"] = dict(estimate=est, peak=peak,
                                                 ratio=ratio)
        if not 0.5 <= ratio <= 2.0:
            raise AssertionError(f"sizing 2x{dens[0].npts}, {n_out} chains: "
                                 f"estimate/peak {ratio}")
    return rows


def shared_card_worker(rank, world, port):
    """Phase 11b, one rank: gloo over CUDA tensors, both ranks on cuda:0.
    Prints one JSON line of its findings last."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch import parallel as par
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    par.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                             backend="gloo", timeout=WORKER_TIMEOUT)
    rng = np.random.default_rng(SEED + 13)
    bw = [float(1.06 * N_SLICE ** -0.2)]
    dens = [kt.kde((rng.normal(size=(2, N_SLICE)) + s).astype(np.float32),
                   bw, device=dev, dtype=torch.float32) for s in (0.0, 0.5)]
    out = {"rank": rank}
    ru, rn = _replay_streams(np.random.default_rng(SEED + 14), SHARED_CHAINS,
                             dens, 5)
    kmesh = par.make_mesh(axis_name=par.KERNELS)
    t0 = time.perf_counter()
    _, idx = par.prod_appx_ms_gibbs_kernel_sharded(
        kmesh, SHARED_CHAINS, dens, n_iter=5, rand_u=ru, rand_n=rn)
    _sync()
    out["kernel_sharded_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, want = kt.prod_appx_ms_gibbs(SHARED_CHAINS, dens, n_iter=5,
                                    rand_u=ru, rand_n=rn)
    _sync()
    out["kernel_plain_s"] = time.perf_counter() - t0
    out["kernel_agree"] = _agree(idx, want, "kernel-sharded S = 2")
    t0 = time.perf_counter()
    _, idx = par.prod_appx_ms_gibbs_sharded(par.make_mesh(), N_SLICE, dens,
                                            n_iter=5, key=SEED)
    _sync()
    out["chain_sharded_s"] = time.perf_counter() - t0
    if rank == 0:
        t0 = time.perf_counter()
        _, want = kt.prod_appx_ms_gibbs(N_SLICE, dens, n_iter=5, key=SEED,
                                        select="cdf")
        _sync()
        out["chain_plain_s"] = time.perf_counter() - t0
        out["chain_agree"] = _agree(idx, want, "chain-sharded over 2 ranks")
    # the components split over the two ranks: each local part launches
    # the kernel, and the result stays on the card
    from kde_tpu_torch.ops import kernels, tiled_eval
    qs = torch.as_tensor(np.random.default_rng(SEED + 15).normal(
        size=(N_SLICE, 2)), dtype=torch.float32, device=dev)
    k = dens[0]
    n0 = tiled_eval.LAUNCHES
    t0 = time.perf_counter()
    lp = par.sharded_log_eval(kmesh, qs, k.points, k.bw, k.weights)
    _sync()
    out["log_eval_sharded_s"] = time.perf_counter() - t0
    n = out["log_eval_launches"] = tiled_eval.LAUNCHES - n0
    if n < 1 or not lp.is_cuda:
        raise AssertionError(f"sharded_log_eval S = 2: {n} launches, result "
                             f"on {lp.device}")
    out["log_eval_err"] = compare(lp, kernels.log_eval_gated(
        qs, k.points, k.bw, k.weights), "sharded_log_eval S = 2")
    torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)


def phase_shared_card():
    """Phase 11b: two copies of this script in worker mode share the card
    in a gloo world (NCCL refuses two ranks on one device); a worker that
    fails or outlives WORKER_TIMEOUT fails the phase."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shared-card-worker",
         str(r), "2", port], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    deadline = time.monotonic() + WORKER_TIMEOUT
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, text) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            raise AssertionError(f"shared-card rank {r} exited "
                                 f"{proc.returncode}:\n{text[-4000:]}")
    return [json.loads(text.strip().splitlines()[-1]) for text in outs]


K1_AB_SHAPES = {"a": (N_SLICE, N_SLICE, 2, False),
                "b": (N_SLICE, N_SLICE, 1, True),
                "e": (N_UNSCENTED, N_UNSCENTED, 1, True),
                "d3": (N_SLICE, N_SLICE, 3, False),
                "d8": (N_SLICE, N_SLICE, 8, False),
                "d9": (N_SLICE, N_SLICE, 9, True),
                "d16": (N_SLICE, N_SLICE, 16, False)}
K1_SWEEP = ("a", "b", "e")
K1_HOST_CALLS = 2000     # wrapper calls timed on the host clock, 128 x 128


def k1_parent_ab(parent):
    """Time this checkout's K1 against ``parent``'s (the ``tiled_eval``
    module of another checkout, e.g. an unpacked ``git archive``, loaded
    from its file) on this card, in turns: parent, change, change, parent.
    At every shape of K1_AB_SHAPES both must pass ``compare`` against this
    checkout's twin; each side is timed single-call and back-to-back
    (``_cuda_ms``), beside the bound (``k1_bound_ms``).  Then the host cost of one wrapper call at 128 x 128,
    every plan of ``tiled_eval.plans`` at K1_SWEEP's shapes (back-to-back,
    one launch each), and the SM clock under K1."""
    import torch
    from kde_tpu_torch.ops import tiled_eval
    path = os.path.join(os.path.abspath(parent), "kde_tpu_torch", "ops",
                        "tiled_eval.py")
    spec = importlib.util.spec_from_file_location("k1_parent", path)
    old = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old)
    mods = {"parent": old, "change": tiled_eval}
    for name, mod in mods.items():
        mod.build()
    ptxas = [ln.split(":", 1)[1].strip() for ln in
             tiled_eval.BUILD_LOG.splitlines()
             if "entry function" in ln or "registers" in ln]
    print(f"k1 ptxas: {json.dumps(ptxas)}", flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = _sm_clock_hz()
    rng = np.random.default_rng(SEED)
    for shape, (m, n, d, loo) in K1_AB_SHAPES.items():
        args = k1_inputs(rng, m, n, d, loo, dev)
        want = tiled_eval.tiled_log_eval_ref(*args, loo=loo)
        row = {"shape": shape, "M": m, "N": n, "d": d, "loo": loo,
               "plan": tiled_eval.launch_plan(m, n, d, sms)._asdict()}
        row["bound_ms"], row["bound_by"] = k1_bound_ms(m, n, d, loo, sms,
                                                     clock)
        for name, mod in mods.items():
            got = mod.tiled_log_eval(*args, loo=loo)
            _sync()
            row[f"{name}_max_abs_err"] = compare(got, want, f"{name} ({shape})")
        for name in ("parent", "change", "change", "parent"):
            call = functools.partial(mods[name].tiled_log_eval, *args, loo=loo)
            row.setdefault(f"{name}_ms", []).append(_cuda_ms(call))
            row.setdefault(f"{name}_ms_back_to_back", []).append(
                _cuda_ms(call, inner=10))
        print(f"k1 ab: {json.dumps(row)}", flush=True)
    small = k1_inputs(rng, 128, 128, 2, False, dev)
    host = {}
    for name in ("parent", "change", "change", "parent"):
        _sync()
        t0 = time.perf_counter()
        for _ in range(K1_HOST_CALLS):
            mods[name].tiled_log_eval(*small)
        host.setdefault(name, []).append(
            1e6 * (time.perf_counter() - t0) / K1_HOST_CALLS)
        _sync()
    print(f"k1 host us per call, 128 x 128: {json.dumps(host)}", flush=True)
    for shape in K1_SWEEP:
        m, n, d, loo = K1_AB_SHAPES[shape]
        args = k1_inputs(rng, m, n, d, loo, dev)
        ms = {f"{p.threads}x{p.splits}": _cuda_ms(functools.partial(
            tiled_eval.launch_with_plan, *args, loo, p), inner=10)
            for _, p in tiled_eval.plans(m, n, d, sms)}
        print(f"k1 sweep ({shape}): {json.dumps(ms)}", flush=True)
    args = k1_inputs(rng, N_SLICE, N_SLICE, 2, False, dev)
    tiled_eval.tiled_log_eval(*args)
    _sync()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], stdout=subprocess.PIPE,
        text=True)
    for _ in range(5000):                  # ~1 s of K1 while it reads
        tiled_eval.tiled_log_eval(*args)
    smi = smi.communicate(timeout=60)[0].strip()
    _sync()
    print(f"k1 under load, clocks/power/temperature: {smi}", flush=True)
    print(_card())


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: "
                         "torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from concurrent.futures import ThreadPoolExecutor
    from kde_tpu_torch import native
    from kde_tpu_torch.ops import host_small, tiled_eval
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card()

    # 1. device
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. build: the three libraries at once, each timed from the start
    t0 = time.perf_counter()

    def timed_build(build):
        so = build()
        return so, time.perf_counter() - t0
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(timed_build, b) for b in
                (tiled_eval.build, host_small.build, native.build)]
        (k1_so, k1_s), (small_so, small_s), (tree_so, tree_s) = [
            j.result() for j in jobs]
    for name, mod, so, sec in (("", tiled_eval, k1_so, k1_s),
                               (" small ops", host_small, small_so, small_s)):
        ptxas = [ln.strip() for ln in mod.BUILD_LOG.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"build{name}: {sec:.2f} s -> {os.path.relpath(so)}; ptxas: "
              f"{ptxas[:6]}", flush=True)
    print(f"build native ball tree (g++ {' '.join(native.CXX_FLAGS)}): "
          f"{tree_s:.2f} s -> {os.path.relpath(tree_so)}", flush=True)

    # 3. kernel vs plain twin; 3b. the small-route kernels
    rows, worst = phase_kernel(dev)
    small_rows, small_worst = phase_small(dev)

    # 3c-12. the main paths; only their launches count, each path's read
    # just after it ran (and the native tree builds, likewise)
    runs, builds, small = {}, {}, {}

    def run(name, fn, *args):
        tiled_eval.LAUNCHES = native.BUILDS = 0
        host_small.LAUNCHES.update(dict.fromkeys(host_small.LAUNCHES, 0))
        out = fn(*args)
        runs[name], builds[name] = tiled_eval.LAUNCHES, native.BUILDS
        small[name] = dict(host_small.LAUNCHES)
        return out

    c1 = run("cfg1", phase_cfg1, dev)
    print(f"README cfg 1 on {card}: {json.dumps(c1)}", flush=True)
    for k in host_small.LAUNCHES:
        if small["cfg1"][k] < 1:
            raise AssertionError(f"README cfg 1 never launched {k}")

    sl, (p, q) = run("slice", phase_slice, dev)
    print(f"slice 2x{N_SLICE} 2-D `*` on {card}: {json.dumps(sl)}",
          flush=True)
    sv, serve = run("serve", phase_serve, dev)
    print(f"serve 2x{N_SERVE} comps, {SERVE_CHAINS} chains on {card}: "
          f"{json.dumps(sv)}", flush=True)
    dp = run("device_plan", phase_device_plan, dev, p, q)
    print(f"device plan 2x{N_SLICE} `*` and chained `*` on {card}: "
          f"{json.dumps(dp)}", flush=True)
    bt = run("batched", phase_batched, dev)
    print(f"product_batched {BATCH_SETS}x[2x{N_SLICE}] on {card}: "
          f"{json.dumps(bt)}", flush=True)
    run("select", phase_select, dev, serve, (p, q))
    fn = run("functionals", phase_functionals, dev, p, q)
    print(f"functionals, sampling, serialization on 2x{N_SLICE} on {card}: "
          f"{json.dumps(fn)}", flush=True)
    mf = run("manifolds", phase_manifolds, dev)
    print(f"manifold products 2x{N_SLICE}, batched {BATCH_SETS} sets on "
          f"{card}: {json.dumps(mf)}", flush=True)
    pl = run("parallel", phase_parallel, dev, p, q, serve)
    print(f"parallel 11a, one NCCL rank, on {card}: {json.dumps(pl)}",
          flush=True)
    sc = phase_shared_card()
    # counted in the two worker processes, around the sharded call only
    runs["shared_card"] = sum(r["log_eval_launches"] for r in sc)
    print(f"parallel 11b, two gloo ranks sharing the card, on {card}: "
          f"{json.dumps(sc)}", flush=True)
    run("examples", phase_examples, dev)
    for name in ("slice", "device_plan", "batched", "functionals",
                 "manifolds", "parallel", "shared_card"):
        if runs[name] < 1:
            raise AssertionError(f"path {name} never launched the kernel")
    main_launches = sum(runs.values())
    small_launches = {k: sum(r[k] for r in small.values())
                      for k in host_small.LAUNCHES}
    print(f"kernel launches per path: {json.dumps(runs)}", flush=True)
    print(f"small-route kernel launches per path: {json.dumps(small)}",
          flush=True)
    print(f"native tree builds per path: {json.dumps(builds)}", flush=True)
    golden, ev = small_rows["loo_golden cfg1"], small_rows[
        "small_log_eval cfg1"]
    print(json.dumps({"kernels": [{
        "name": "tiled_log_eval", "route": "cuda",
        "source": "kde_tpu_torch/csrc/tiled_eval.cu",
        "replaces": "kde_tpu/ops/pallas_eval.py:31",
        "launches": main_launches, "max_abs_err": worst,
        "ms": rows["a"]["ms"], "plain_ms": rows["a"]["plain_ms"],
        "bound_ms": rows["a"]["bound_ms"], "bound_by": rows["a"]["bound_by"],
        "bound_share": rows["a"]["bound_share"], "library_ms": None,
        "ms_b": rows["b"]["ms"], "bound_ms_b": rows["b"]["bound_ms"],
        "bound_share_b": rows["b"]["bound_share"],
        "ms_back_to_back": rows["a"]["ms_back_to_back"],
        "ms_b_back_to_back": rows["b"]["ms_back_to_back"],
        "dense_ms": rows["a"]["dense_ms"]}, {
        "name": "loo_golden", "route": "cuda",
        "source": "kde_tpu_torch/csrc/small_ops.cu",
        "replaces": "kde_tpu/native/hostops.cpp:260",
        "launches": small_launches["loo_golden"],
        "max_abs_err": small_worst["loo_golden"], "ms": golden["ms"],
        "plain_ms": golden["plain_ms"], "bound_ms": golden["bound_ms"],
        "bound_by": golden["bound_by"], "library_ms": None,
        "parent_f32_ms": golden["parent_f32_ms"],
        "parent_f64_ms": golden["parent_f64_ms"],
        "empty_ms": golden["empty_ms"]}, {
        "name": "small_log_eval", "route": "cuda",
        "source": "kde_tpu_torch/csrc/small_ops.cu",
        "replaces": "kde_tpu/native/hostops.cpp:292",
        "launches": small_launches["small_log_eval"],
        "max_abs_err": small_worst["small_log_eval"], "ms": ev["ms"],
        "plain_ms": ev["plain_ms"], "bound_ms": ev["bound_ms"],
        "bound_by": ev["bound_by"], "library_ms": ev["library_ms"],
        "parent_f32_ms": ev["parent_f32_ms"],
        "empty_ms": ev["empty_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shared-card-worker"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        shared_card_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--k1-parent"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        k1_parent_ab(sys.argv[2])
    else:
        main()
