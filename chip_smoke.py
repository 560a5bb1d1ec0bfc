#!/usr/bin/env python3
"""Drive the kde_tpu_torch main path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line of findings each:
  1. device: the card's name and power limit, torch/CUDA versions, TF32
     flags (both off);
  2. build, all started together: nvcc compiles kde_tpu_torch/csrc/
     tiled_eval.cu, csrc/small_ops.cu, csrc/gibbs_select.cu,
     csrc/gibbs_chain.cu, csrc/loo_search.cu, csrc/sharded_select.cu and
     csrc/sharded_loo.cu (sm_90a, all but the first with --fmad=false),
     g++ the native
     ball-tree source csrc/balltree.cpp; ptxas registers, shared memory
     and spills;
  3. the kernel against its plain torch twin on the card at five shapes,
     rtol = atol = 2e-4: (a) 20k x 20k, d = 2; (b) LOO 20k, d = 1;
     (c) 1000 x 777, d = 3; (d) LOO N = 1 (-inf); (e) LOO 100k, d = 1 (the
     unscented kld's fit); CUDA-event times of kernel and twin at (a), (b)
     and (e) beside the kernel's bound (SFU ex2 rate, FP32 rate, bytes) and,
     at (a) and (b), the dense route as context; (f) data at 10^3 against
     the float64 twin (atol 1e-4, rtol 1e-5); (g) LOO with a diagonal
     offset (query m skips component m + diag) at the shapes of phase 11's
     shards, 10k x 20k and 20k x 10k in 2-D, each query on the component
     it skips: 0, +-1, +- a query block, across a split boundary, +-N/2
     (phase 11b's ranks) and past either end, rtol = atol = 2e-4 against
     the twin; diag = 0 bitwise the call without it and an offset past
     either end bitwise the call without LOO, on every launch plan;
 3b. the float64 small-route kernels of csrc/small_ops.cu against their
     plain twins on the card: the LOOCV selection ksize_small (the bracket
     and every row's golden search in one launch, each row on a
     thread-block cluster) on README cfg 1 (N = 100, d = 1), N = 120 in
     2-D, the 1-D gate edge N = 255, zero-weight kernels, N = 1 and N = 2,
     at every cluster size C the card admits (1, 2, 4, 8, 16) and at the
     plan's, bitwise the same over repeated launches, and the search alone
     (loo_golden) from the twin's bracket (selections to rtol 1e-9);
     small_log_eval at 200 x 100, d = 1, at 200 x 300, d = 4 (the widest
     under the gate), LOO at N = 100 and 255 and the exp-wrap queries (log
     p to atol 1e-10).  CUDA-event times (ksize_small at cfg 1, 2-D and the
     gate edge, at C = 1 and the plan's C; small_log_eval at the two
     evaluation shapes): one call with its wrapper, 20 back-to-back calls a
     window (the per-call host floor) and the device time per call from a
     CUDA graph of 20 calls, beside the twin, the parent's routes for the
     same call (the float32 and float64 dense golden loops, the float32
     dense evaluation), an empty launch of the same library and the bound;
     at the evaluation shapes also torch.distributions' MixtureSameFamily
     log_prob, the one PyTorch call that computes the same function; the
     registers, shared memory and spills of each small-ops kernel (ptxas);
 3d. the Gibbs selection kernel gibbs_select (csrc/gibbs_select.cu)
     against its plain twin: the slice's leaf stages (20,000 chains x
     20,000 candidates, d = 2, sweep with cov and conditioning without,
     cdf and gumbel, float32; gumbel's counter noise drawn in the kernel
     for chains from GUMBEL_CHAIN0, selections from GUMBEL_SEL0), float64
     replay streams, circular and SE(2)
     stages, padding with forced-dead rows and a mixed active dim, d =
     1..8 at a small width, and widths at the warp/block and shared-memory
     switch points; cdf's tiles (k2_tile_cases) at their chunk edges,
     threshold width and rows, padded and dead rows, d = 1..8 and 17,
     float32 and float64, uniform and varied bandwidths; gumbel labels
     equal on every row, cdf labels but for float64 CDF ties within 1e-12
     of u (listed), gathered stats equal; the leaf stages, cdf also with
     uniform bandwidths, timed (one call, 20 back-to-back) beside the
     twin, the bound (k2_bound_ms) and torch.multinomial, for scale only;
 3e. the Gibbs chain kernel gibbs_chain (csrc/gibbs_chain.cu) against
     its plain twin (phase_gibbs_chain): cdf, then gumbel (K3_GUMBEL) on
     the warp, block and staged layouts, float32 and float64, circular,
     SE(2), ragged (padded) levels and dead rows, equal on every chain,
     timed at the slice, serve, the headline and the batched shape;
 3f. the LOOCV search kernel loo_search (K4, csrc/loo_search.cu) against
     its plain twin at the main path's searches (K4_CASES: the slice's
     fit and refit, the batched refit, the dense range, the unscented
     fit, phase 9's float64 ksize on the grid plan; 2 x 256, the `*`
     refit of 1,000-sample beliefs, the headline's batched refit 12 x
     1,000, 2 x 1,100, 2 x 2,048, 2 x 4,096, 2 x 16,384 and a float64
     ksize at 2 x 1,000 on the rows plan): float64 to rtol 1e-10,
     float32 probe values within 2e-5 of the twin's entropies and picks
     within the final bracket, bitwise repeats, one launch a call; timed
     beside k4_bound_ms, the twin and ksize_rows on the twin (the
     parent's route);
 3g. the kernel-sharded selection kernel sharded_select (K6,
     csrc/sharded_select.cu) against its plain twins (phase_sharded_select):
     every phase's outputs and the winner's stats, the shards of S = 1
     slices and S = 2 halves composed on one rank, float32 and float64,
     d = 1, 2, 3, circular and SE(2), dead rows, shards holding only
     padding, a partial mask, dn = 3, uniform bandwidths (every dim, one
     dim, one shard's half), widths 1 and at the plan's chunk boundaries
     (k6_chunk_widths); the global index equal but for float64 CDF ties
     within 1e-12 of u (listed); each phase of the leaf stages of phase
     11a's replay (256 chains over 2 x 50,000) and of the full-width
     case's (2 x 1,000,000), with varied and with uniform bandwidths,
     timed with its wrapper (prepare, once a stage, among them) and as a
     bare kernel call (k6_raw_calls) beside its twin, their sum beside
     k6_bound_ms;
 3h. the sharded LOOCV search's kernels sharded_loo (K7,
     csrc/sharded_loo.cu) against their plain twins (phase_sharded_loo)
     at phase 11a's search (N_KSIZE points in 2-D) and the full-width one
     (K7_BIG_N), float32 and float64, S = 1 on one NCCL rank: every launch
     of sweeps 0-2 and the closing step (staging, shifts, each sweep's
     head and the golden step bitwise, entropies within 1e-12 / 2e-5), at
     11a's shape also over 4 query shards (the chunked plan), repeated
     searches bitwise equal, at 11a's shape the twin search's picks
     (float64 within 1e-10, float32 within KSIZE_RTOL); each launch timed
     beside its twin, the search beside k7_bound_ms and the twin search;
 3c. README cfg 1 end to end with the package's defaults (kde(x), p(grid),
     resample(p, 75, "lcv"), the LOO evaluate): float64 results equal to
     the same flow on the CPU, both small kernels launched; flows/s with
     the gates at their values and with the port's gates at 0 (the
     parent's routes), in turns;
  4. the `*` slice at 2 x 20,000 components in 2-D: LOOCV fits, the host
     ball trees (built natively: two native builds; p's tree rebuilt once
     with the NumPy builder must equal it array for array), the Gibbs
     product (20,000 chains, Niter 5), the LOOCV refit of the samples and
     the evaluation at 20,000 queries -- fit and refit must launch K4,
     evaluate K1; the product again with every Gibbs selection on
     gibbs_select's twin (_on_gibbs_twin, the same seed and chain blocks),
     the A/B of its Gibbs stage;
  5. serving: ProductSampler over 2 x 50,000-component densities,
     256 chains per request, then the same requests on the twin;
  6. the device-built plan at full width: device-resident copies of
     phase 4's densities (no host arrays, no tree), `p' * q'` and the
     chained `(p'q') * q'`; no host tree may be built, the refits must
     launch K4, the means must match the analytic products;
  7. the batched product: product_batched over B = 4 device-resident sets
     of two 20,000-component 2-D densities (plan build, Gibbs, refit),
     the same call on the twin, set 0 against its standalone draw, then a
     refresh;
  8. label selection: samples/s of cdf, blocked and gumbel at the bench
     headline (B = 6 x [2 x 1000], 1000 chains, Niter 5), at B = 8, at
     phase 5's 2 x 50,000 with 256 chains and at phase 4's Gibbs stage
     (2 x 20,000, 20,000 chains), with each mode's launches a call (cdf
     and gumbel: one gibbs_chain launch, no gibbs_select launch);
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
     sets, set 0 against its standalone draw; each product and the batch
     again on the twin; the circular pair with a lone circular diffop
     (explicit hooks), cdf and gumbel, on gibbs_select's stage route
     against its twin;
 10b. a keyed cdf product of MANY_DENS = 20 densities of N_MANY 2-D
     points (more than the chain kernel takes), MANY_CHAINS chains: the
     stage route, one gibbs_select launch a step; its Gibbs seconds, its
     launches and its labels against the same call on the twin;
 11. the distributed layer (kde_tpu_torch.parallel).  (a) In a one-rank
     NCCL world: the chain-sharded product of phase 4's densities
     (20,000 chains) and the kernel-sharded replay product of phase 5's
     (256 chains) against the unsharded engine (labels on >= 99.9 % of
     chains; every selection on K6, none on its twins; its collectives
     counted against comm_table; timed in turns with the plain engine),
     the full-width case (256 chains over 2 x 1,000,000 on K6 against
     its twins, labels equal but for listed ties, one chain block
     against four, the allocator's peak), product_sharded (its refit
     must launch K4),
     product_batched(mesh=) over 4 x [2 x 20,000] against the unsharded
     batch, sharded_log_eval at 20,000 x 20,000 (must launch the kernel),
     sharded_loo_entropy and ksize_bandwidths_sharded against their
     single-device calls (the entropy at N_LOO = 20,000 points one K1
     launch, and at N_LOO_BIG = 100,000 one K1 launch within RTOL of
     entropy_kernel, its host and CUDA-event ms beside K1's alone and its
     allocator peak under 16 MB above its inputs; at N_LOO_DENSE = 4,096,
     below the gate, no K1 launch and within RTOL of entropy_kernel; the
     bandwidths on K7
     only, no twin phase, K4 or
     K1 launch, within KSIZE_RTOL of K4's twin search and K4's final
     bracket of K4's picks, its probe values within K4_PROBE_RTOL of the
     eager entropy at the same x; its sweeps, the all-reduces it issued
     (one a sweep), host waits, each on a sweep before the one just
     issued, the allocator's peak and the
     device's idle share under torch.profiler; the full-width search of
     K7_BIG_N points against K4), the same three and
     ksize_bandwidths_device on
     NumPy inputs (on the card, equal to the tensor calls),
     estimate_product_memory against the allocator's peak (estimate /
     peak in [1, 2]: the estimate is never below the peak), then
     scaling_bench.run at S = 1 (4,096 chains, 2 x 1,000 components,
     Niter 5) and its comm_table.  (b) Two copies of this script
     (``--shared-card-worker``) share the card in a gloo world: the
     kernel-sharded product at S = 2 (on K6 on both ranks, 1,024 chains
     over 2 x 20,000) and the chain-sharded product over
     both ranks against the plain engine, ksize_bandwidths_sharded with
     the queries split over both ranks (on K7 on each, the same picks
     on both, within K4's final bracket of rank 0's single-card search),
     sharded_log_eval with the
     components split over both ranks (each rank must launch the kernel
     and keep the result on the card), and sharded_loo_entropy of N_LOO
     points on a kernels mesh of two and a chains mesh of two (one K1
     launch a call on each rank, rank 1's offset -N/2 and +N/2, within
     RTOL of entropy_kernel).  Launches made by the references
     that a sharded call is compared with are not counted;
 12. the eight examples_torch twins on the card at their own sizes, one
     line each (their checks raise; they stay below the kernel's gates).
 13. the accelerator tools of tools_torch/: validate_cuda's quick rows
     (QUICK: the reference grid's (D 2, M 2) and (D 3, M 6, mcmc 10) on
     host and device plans, 1,000 chains over 2 x 100k on K3's block
     layout, 4,100 chains over 2 x 100k on its staged layout, the bench
     headline B = 6 x [2 x 1,000] on its warp layout, circular M = 2 and
     its hook-free control, which must fail the brackets, and the same
     with gumbel but the headline); the envelope's mem stage at N = 50k
     and 400k for cdf and gumbel (estimate / peak in [1, 2]) and its time
     stage at 400k, cdf against gumbel, one round, each a gibbs_chain
     launch and no gibbs_select launch; one line each with its seconds.
gibbs_chain must launch on the slice, serve, device plan, batched,
select, manifolds, parallel (chain- and set-sharded), examples and tools
paths, gibbs_select on phase 10's lone circular diffop and phase 10b's
product (which launches no gibbs_chain) and never on
phase 8's and phase 13's (gumbel is on gibbs_chain), sharded_select and
sharded_loo on the parallel and shared-card paths (with no twin stage)
and nowhere else, K1 on the slice,
functionals, parallel and shared-card paths, K4 on the slice, device
plan, batched, functionals, manifolds and parallel paths.
Then one JSON line on the kernels, and last the device JSON line.  Any
failed check raises, so the script exits nonzero and prints no result.  It
refuses to run without a card.

    python3 chip_smoke.py --k1-parent DIR

times K1 only, against the K1 of the checkout in DIR (see k1_parent_ab).

    python3 chip_smoke.py --small-parent DIR

times the small-route kernels only, against those of the checkout in DIR
(see small_parent_ab).

    python3 chip_smoke.py --k2-diag

times gibbs_select under each layout (cdf's tiles among them), the switch
between the block layout and the tiles along the rows of a launch and the
width of the level, its wrapper's host cost and a serve request without
it (see k2_diag).

    python3 chip_smoke.py --k3-diag

times the chain kernel's layouts with ablations built from its source, cdf
and gumbel, and the switch between them (see k3_diag).

    python3 chip_smoke.py --k3-parent DIR

times the chain kernel only, against the one of the checkout in DIR (see
k3_parent_ab).

    python3 chip_smoke.py --k4-diag

splits one K4 call on each plan at K4_DIAG_CASES from a diag build's
stamps, times the rows plan's cluster barrier against its per-row counter,
and sweeps the switch between the plans (see k4_diag).

    python3 chip_smoke.py --k4-parent DIR

holds K4 against the K4 of the checkout in DIR at phase 3f's searches,
times both in turns, and the small refits end to end (see k4_parent_ab).

    python3 chip_smoke.py --k7-parent DIR

holds K4 against the K4 of the checkout in DIR, bitwise, splits one
sharded LOOCV search's time on each side, and times the search against
DIR's along N, in turns (see k7_parent_ab).

    python3 chip_smoke.py --k7-split DIR

splits one sharded LOOCV search of the checkout in DIR only (see
k7_split).

    python3 chip_smoke.py --k6-parent DIR

holds K2 bitwise against the K2 of the checkout in DIR at phase 3d's
cases, and times K6 against DIR's at the timed stages of phase 3g and the
full-width replay against DIR's engine, in turns (see k6_parent_ab).

    python3 chip_smoke.py --k2-parent DIR

holds K2's gumbel labels at phase 3d's cases and K6's phase outputs at
phase 3g's bitwise against the builds of the checkout in DIR, and times
K2's cdf against DIR's in turns at 3d's leaf stages (varied and uniform),
phase 10's lone circular diffop product and phase 10b's product (see
k2_parent_ab).

    python3 chip_smoke.py --k6-trace TAG [DIR]

profiles phase 11a's kernel-sharded replay on the checkout it runs from
and writes DIR/k6_trace_TAG.json.gz (default k6_traces/; see k6_trace).
"""

import contextlib
import functools
import importlib.util
import inspect
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
FP32_LANES_PER_CLK = 128 # FP32 lanes per SM, compute capability 9.0
INT32_LANES_PER_CLK = 64 # INT32 lanes per SM, compute capability 9.0
# integer operations of the counter generator (csrc/counter_rng.cuh): a
# Threefry-2x32 block (2 counter words, 2 key adds, 20 rounds of add,
# rotate and xor, 5 key injections of 2 adds) and the map of a word to
# float32 (shift, or); a block gives two float32 candidates or one float64
THREEFRY_INT_OPS = 74
WORD_INT_OPS = 2
GUMBEL_CHAIN0, GUMBEL_SEL0 = 1000, 7     # phase 3d's gumbel offsets
K2_TIE = 1e-12           # gibbs_select cdf labels may differ from the
                         # twin's only where its float64 CDF is this near u
K2_MAX_TIES = 100        # ...on at most this many rows of a case
# --k2-diag: the rows of a launch and the level widths along which the
# block layout and cdf's tiles are timed
K2_DIAG_ROWS = (256, 512, 1024, 2048, 3072, 4096, 6144, 8192, 16384)
K2_DIAG_WIDTHS = (1536, 2048, 4096, 8192, 12288, 16384, 20000, 50000)
FP32_FLOPS = 67e12       # H100 SXM, outside the tensor cores
HBM_BYTES = 3.35e12      # H100 SXM
AGREE_MIN = 0.999        # sharded vs unsharded: share of chains that agree
MANY_DENS = 20           # phase 10b: a product of more densities than K3
N_MANY = 5000            # takes (gibbs_chain.MAX_DENS = 16), of this many
MANY_CHAINS = 4096       # 2-D points each, this many chains: K2 a step
N_LOO = 20_000           # sharded LOO entropy: above the gate, on K1
N_LOO_BIG = 100_000      # ...and its full-width case on the (1, 1) mesh
N_LOO_DENSE = 4096       # ...and below the gate (N^2 pairs, not above
                         # config.DIRECT_PAIR_LIMIT): one block of logits
LOO_PEAK_BYTES = 16 << 20   # its allocator peak above its inputs: O(N)
N_KSIZE = 8192           # sharded LOOCV bandwidths
KSIZE_RTOL = 1e-5        # sharded vs single-device bandwidths, float32
                         # (first set at 1e-3; the H100 read 0.0)
SHARED_CHAINS = 1024     # phase 11b kernel-sharded replay chains
WORKER_TIMEOUT = 300     # seconds: phase 11b workers, collectives
SIZING_BAND = (1.0, 2.0)  # phase 11a and 13: estimate / allocator peak
ENVELOPE_NS = (50_000, 400_000)   # phase 13: the envelope's mem rows
SCALING = dict(total_chains=4096, n_comp=1000, n_iter=5)   # kde_tpu's run()
FP64_FLOPS = 34e12       # H100 SXM, FP64 outside the tensor cores
FP64_LANES_PER_CLK = 64  # FP64 lanes per SM, compute capability 9.0
K4_TOL = 1e-2            # the LOOCV search's tolerance (kde's default)
K4_F64_RTOL = 1e-10      # float64 K4 vs its twin: the same trajectory
K4_PROBE_RTOL = 2e-5     # float32 K4's probe values vs the twin's entropy
# phase 3f, the searches of the main path: name -> (rows, points, dtype,
# data: "fit" N(0, 1) rows, "refit" N(0.25, 1/2) rows, a product's samples)
K4_CASES = {"slice fit": (2, N_SLICE, "float32", "fit"),
            "* refit": (2, N_SLICE, "float32", "refit"),
            "batched refit": (2 * BATCH_SETS, N_SLICE, "float32", "refit"),
            "dense 2x4096": (2, 4096, "float32", "fit"),
            "dense 2x16384": (2, 16384, "float32", "fit"),
            "unscented fit": (1, N_UNSCENTED, "float32", "fit"),
            "ksize f64": (2, N_SLICE, "float64", "fit"),
            "2x256": (2, 256, "float32", "fit"),
            "* refit 2x1000": (2, 1000, "float32", "refit"),
            "batched refit 12x1000": (12, 1000, "float32", "refit"),
            "2x1100": (2, 1100, "float32", "fit"),
            "2x2048": (2, 2048, "float32", "fit"),
            "ksize f64 2x1000": (2, 1000, "float64", "fit")}
# --k4-diag: the 3f searches whose K4 call is split by the diag build
K4_DIAG_CASES = ("2x256", "* refit 2x1000", "batched refit 12x1000",
                 "2x1100", "2x2048", "dense 2x4096", "dense 2x16384",
                 "ksize f64 2x1000")
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
    rows["g"], err = phase_kernel_diag(dev, rng, sms)
    print(f"kernel (g): {json.dumps(rows['g'])}", flush=True)
    return rows, max(worst, err)


K1_DIAG_SHAPES = ((N_LOO // 2, N_LOO, 2), (N_LOO, N_LOO // 2, 2))


def k1_diag_offsets(m, n, d, sms):
    """Name -> offset of phase 3 (g) for an ``[m, d] x [n, d]`` LOO call:
    0, +-1, +- one query block of the chosen plan, query block 0's skipped
    columns across the plan's first split boundary (entering its chunks
    part-way), the +-N/2 of phase 11b's ranks where it fits, and past
    either end."""
    from kde_tpu_torch.ops import tiled_eval
    plan = tiled_eval.launch_plan(m, n, d, sms)
    block = plan.threads * plan.rows_per_thread
    out = {"0": 0, "+1": 1, "-1": -1, "+block": block, "-block": -block,
           "split": plan.per_split - block // 2 - 3,
           "past_n": max(m, n) + 5, "past_m": -max(m, n) - 5}
    out["+N/2" if m < n else "-N/2"] = (n if m < n else -m) // 2
    return out


def k1_diag_inputs(rng, m, n, d, diag, dev):
    """K1's float32 inputs with query i on the component it skips, mean
    i + diag, where that is a column: a mask missed or misplaced moves the
    row far beyond the tolerance."""
    import torch
    mu = rng.normal(size=(n, d))
    q = rng.normal(size=(m, d))
    i = np.arange(m)
    on = (i + diag >= 0) & (i + diag < n)
    q[on] = mu[i[on] + diag]
    var = rng.uniform(0.005, 0.05, size=(n, d))
    w = rng.uniform(0.1, 1.0, size=n)
    return [torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (q, mu, var, w / w.sum())]


def phase_kernel_diag(dev, rng, sms):
    """Phase 3 (g): K1's LOO mask at a diagonal offset against the twin
    on the chosen plan, and on every plan of the shape that diag = 0 is
    bitwise the call without an offset and an offset past either end
    bitwise the call without LOO.  Returns the row and the largest
    error."""
    import torch
    from kde_tpu_torch.ops import tiled_eval
    row, worst = {}, 0.0
    for m, n, d in K1_DIAG_SHAPES:
        plans = [p for _, p in tiled_eval.plans(m, n, d, sms)]
        for name, diag in k1_diag_offsets(m, n, d, sms).items():
            args = k1_diag_inputs(rng, m, n, d, diag, dev)
            got = tiled_eval.tiled_log_eval(*args, loo=True, diag=diag)
            _sync()
            want = tiled_eval.tiled_log_eval_ref(*args, loo=True, diag=diag)
            what = f"case (g) {m}x{n} diag {name} ({diag})"
            err = compare(got, want, what)
            worst = max(worst, err)
            row[f"{m}x{n} {name}"] = {"diag": diag, "max_abs_err": err}
            if name == "0" or name.startswith("past"):
                for plan in plans:
                    a = tiled_eval.launch_with_plan(*args, True, plan, diag)
                    b = tiled_eval.launch_with_plan(*args, name == "0",
                                                    plan)
                    if not torch.equal(a, b):
                        raise AssertionError(f"{what}: not bitwise the "
                                             f"call without it, {plan}")
                row[f"{m}x{n} {name}"]["bitwise_plans"] = len(plans)
    return row, worst


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


def golden_bound_ms(rows, w, probes, bracket=True):
    """The least time an H100 could take for the selections, counting only
    the work the function needs: with ``bracket``, a row's sort (n log2 n
    comparisons) and its n - 1 node extents with their minimum; once per
    row, the shifted d2 of each live pair (i != j, w_i > 0, w_j > 0:
    difference, square, running minimum, shift); per probe, 4 FP64
    operations per live pair (scale, exp counted as one, weight, add) and a
    log per live row; at 34 TFLOP/s.  Bytes: the rows, weights and (node
    table or brackets) read once, the result written once, at 3.35 TB/s."""
    r, n = rows.shape
    live = int((w > 0).sum())
    pairs = live * (live - 1)
    ops = sum(4 * pairs + p * (4 * pairs + live) for p in probes)
    table = 2 * max(n - 1, 0)
    if bracket:
        ops += r * (n * max(1, int(np.ceil(np.log2(max(n, 2))))) + table)
    nbytes = 8 * (r * n + n + r + (table if bracket else 4 * r))
    times = {"operations": ops / FP64_FLOPS, "bytes": nbytes / HBM_BYTES}
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
    current stream (read at each call, as the kernels' wrappers do) through
    the same ctypes path as the two kernels: their timing floor.  Only this
    script uses that entry; the package does not."""
    import ctypes
    import torch
    from kde_tpu_torch.ops import host_small
    lib = host_small._load()
    lib.kde_empty_launch.argtypes = [ctypes.c_void_p]
    lib.kde_empty_launch.restype = ctypes.c_int
    index = torch.device(dev).index or torch.cuda.current_device()
    return lambda: host_small._checked(
        "kde_empty_launch",
        lib.kde_empty_launch(torch._C._cuda_getCurrentRawStream(index)))


def _graph_ms(fn, calls=20, reps=5):
    """Device milliseconds per call of ``fn()``: ``calls`` calls captured
    in one CUDA graph and replayed between CUDA events (median of ``reps``
    replays, after one warm-up call and one warm-up replay), so no host
    work sits between the launches."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def _timings(call, inner=20, graph_call=None):
    """One call's ms with its wrapper (``ms``), ``inner`` back-to-back calls
    a window (``ms_inner20``: the per-call host floor once the card keeps
    up) and the device time per call from a CUDA graph (``device_ms``) of
    ``graph_call`` (default ``call``)."""
    return {"ms": _cuda_ms(call), "ms_inner20": _cuda_ms(call, inner=inner),
            "device_ms": _graph_ms(graph_call or call, calls=inner)}


def ptxas_table(log):
    """Registers, static shared memory and spills of each kernel in the
    ``-Xptxas -v`` output ``log``, by mangled name."""
    import re
    table, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            table[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            table[name]["spill_stores"] = int(m.group(1))
            table[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            table[name]["registers"] = int(m.group(1))
            table[name]["smem"] = int(m.group(2) or 0)
    return table


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


def _rel(got, want):
    return float(((got - want).abs() / want.abs()).max())


def phase_small(dev):
    """Phase 3b: the small-route kernels against their plain twins on the
    card.  The fused selection (ksize_small: bracket and search in one
    launch) at every cluster size the card admits, bitwise the same from
    launch to launch, and the search alone (loo_golden) from the twin's
    bracket; both timed, at C = 1 and at the plan's C, beside the twins,
    the parent's routes, an empty launch, the library call and the bounds.
    Returns the rows printed and the worst error of each kernel."""
    import torch
    from kde_tpu_torch.ops import host_small, kernels, loocv
    rows, worst = {}, {"loo_golden": 0.0, "small_log_eval": 0.0}
    empty = _empty_launch(dev)
    floor = {"empty_ms": _cuda_ms(empty),
             "empty_ms_inner20": _cuda_ms(empty, inner=20),
             "empty_device_ms": _graph_ms(empty)}
    print(f"small empty launch: {json.dumps(floor)}", flush=True)
    for name in ("cfg1", "d2", "gate_edge", "zero_weights", "n1", "n2"):
        x, w = _golden_inputs(name, dev)
        r, n = x.shape
        want = host_small.ksize_small_ref(x, w, SMALL_TOL)
        plan = host_small._cluster(r, n, x.device, None)
        sizes = [c for c in (1, 2, 4, 8, 16) if c < 16
                 or host_small.max_clusters(n, c, x.device.index) > 0]
        errs = {}
        for c in sizes:
            got = [host_small.ksize_small(x, w, SMALL_TOL, cluster=c)
                   for _ in range(3)]
            _sync()
            if not all(torch.equal(g, got[0]) for g in got[1:]):
                raise AssertionError(f"ksize_small ({name}, C = {c}): not "
                                     "bitwise the same from launch to launch")
            errs[c] = _rel(got[0], want)
            if not (bool(torch.isfinite(got[0]).all())
                    and errs[c] <= SMALL_RTOL):
                raise AssertionError(f"ksize_small ({name}, C = {c}): "
                                     f"selection {got[0]} against the twin's "
                                     f"{want}")
        got = host_small.ksize_small(x, w, SMALL_TOL)
        base, ax, bx, cx = host_small._bracket(x)
        args = (x, w, base ** 2, ax, bx, cx)
        search = host_small.loo_golden(*args, SMALL_TOL) * base
        _sync()
        err = float((got - want).abs().max())
        search_rel = _rel(search, want)
        if not (torch.equal(got, host_small.ksize_small(
                x, w, SMALL_TOL, cluster=plan)) and search_rel <= SMALL_RTOL):
            raise AssertionError(f"ksize_small ({name}): the plan's call or "
                                 f"the search alone ({search}) off the twin")
        worst["loo_golden"] = max(worst["loo_golden"], err)
        row = {"R": r, "N": n, "cluster": plan, "max_abs_err": err,
               "max_rel_err_by_cluster": errs, "search_rel_err": search_rel}
        if name in ("cfg1", "d2", "gate_edge"):
            probes = _probes(args)
            row["probes"] = probes
            row["bound_ms"], row["bound_by"] = golden_bound_ms(x, w, probes)
            row.update(_timings(lambda: host_small.ksize_small(x, w,
                                                                SMALL_TOL)))
            c1 = _timings(lambda: host_small.ksize_small(
                x, w, SMALL_TOL, cluster=1))
            row.update({f"{k}_c1": v for k, v in c1.items()})
            row["ms_by_cluster"] = {c: _cuda_ms(
                lambda: host_small.ksize_small(x, w, SMALL_TOL, cluster=c))
                for c in sizes}
            row["search_ms"] = _cuda_ms(lambda: host_small.loo_golden(
                *args, SMALL_TOL))
            row["search_ms_c1"] = _cuda_ms(lambda: host_small.loo_golden(
                *args, SMALL_TOL, cluster=1))
            row["plain_ms"] = _cuda_ms(
                lambda: host_small.ksize_small_ref(x, w, SMALL_TOL), reps=3)
            lo, hi = loocv._slices_on(n, dev)
            for tag, dt in (("f32", torch.float32), ("f64", torch.float64)):
                xr, wr = x.to(dt), w.to(dt)
                row[f"parent_{tag}_ms"] = _cuda_ms(
                    lambda: loocv.ksize_rows(xr, wr, lo, hi, tol=SMALL_TOL),
                    reps=3)
            row.update(floor)
        rows[f"loo_golden {name}"] = row
        print(f"small ksize_small ({name}): {json.dumps(row)}", flush=True)

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
            row.update(_timings(call))
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
            row.update(floor)
        rows[f"small_log_eval {name}"] = row
        print(f"small small_log_eval ({name}): {json.dumps(row)}", flush=True)
    return rows, worst


def k2_inputs(seed, dev, b, c, dn, w, d, js, dtype, cov, codes, mode,
              pad=0, dead=0, mixed=False, uniform=False):
    """``gibbs_select``'s arguments for one level: ``b`` sets of ``dn``
    densities of ``w`` candidates in ``d`` dims (bandwidths at Silverman's
    scale for ``w`` points, weights uniform(0.5, 1.5), each slab's labels a
    permutation), ``c`` chains at N(0, I) (angles uniform on circular
    dims), ``cov`` at the same scale or None; ``pad`` padded candidates in
    the last set, ``dead`` chains of set 0 at 10^3 on the Euclidean dims,
    ``mixed``: density 1's first dim inactive in set 0; ``uniform``: one
    bandwidth a (set, density, dim), the first candidate's of the same
    draws (a fitted density's level), with the level's flags passed as
    ``uniform=`` (each dim's bandwidths checked equal, as
    ``gibbs_chain.level_uniform`` does).  The uniforms (``cdf``) or the
    sets' counter seeds (``gumbel``, chains from GUMBEL_CHAIN0 and
    selections from GUMBEL_SEL0) come from a generator on the card seeded
    with ``seed``.  Returns ``(args, codes, kwargs)``."""
    import torch
    rng = np.random.default_rng(seed)
    circ = np.asarray(codes, dtype=bool)
    mean = rng.normal(size=(b, dn, w, d))
    mean[..., circ] = rng.uniform(-np.pi, np.pi, size=(b, dn, w, circ.sum()))
    h2 = (1.06 * max(w, 2) ** -0.2) ** 2
    bw = h2 * rng.uniform(0.5, 1.5, size=(b, dn, w, d))
    if uniform:
        bw = np.broadcast_to(bw[:, :, :1], bw.shape).copy()
    wt = rng.uniform(0.5, 1.5, size=(b, dn, w))
    logw = np.log(wt / wt.sum(axis=-1, keepdims=True))
    if pad:
        logw[-1, :, -pad:] = -np.inf
    perm = np.argsort(rng.random((b, dn, w)), axis=-1)
    mu = rng.normal(size=(b, c, d))
    mu[..., circ] = rng.uniform(-np.pi, np.pi, size=(b, c, circ.sum()))
    if dead:
        mu[0, :dead, ~circ] = 1e3
    active = np.ones((b, dn, d), dtype=bool)
    if mixed:
        active[0, 1, 0] = False
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    covv = t(h2 * rng.uniform(0.5, 1.5, size=(b, c, d))) if cov else None
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    kw = dict(u=None)
    if mode == "cdf":
        kw["u"] = torch.rand((b, c, len(js)), generator=gen, dtype=dtype,
                             device=dev)
    else:
        kw.update(seeds=torch.randint(0, 1 << 32, (b, 2), generator=gen,
                                      dtype=torch.int64, device=dev),
                  chain0=GUMBEL_CHAIN0, sel0=GUMBEL_SEL0)
    args = (t(mean), t(bw), t(logw), torch.as_tensor(perm, device=dev),
            tuple(js), t(mu), covv, torch.as_tensor(active, device=dev))
    if uniform:
        kw["uniform"] = (args[1] == args[1][:, :, :1]).all(dim=2)
    return args, tuple(codes), kw


def _k2_index(perm_slab, label):
    """The candidate index of ``label`` in a slab's permutation."""
    return int((perm_slab == label).nonzero()[0, 0])


def _twin_cdf(args, codes, bi, ci, jj):
    """The twin's float64 CDF of one row (set ``bi``, chain ``ci``, the
    ``jj``-th density of the stage), by ``ops/gibbs.py``'s own steps."""
    import torch
    from kde_tpu_torch.ops import gibbs, gibbs_select
    lm, lb, lw, lp, js, mu, cov, act = args
    j = js[jj]
    one = lambda x: None if x is None else x[bi:bi + 1, ci:ci + 1]
    lvl = tuple(x[bi:bi + 1] for x in (lm, lb, lw, lp))
    a1 = act[bi:bi + 1]
    stage = gibbs._Stage((j,), one(mu), one(cov), None, a1, a1.cpu().numpy(),
                         gibbs_select.diffop_of(codes))
    lg = stage.logits(j, lvl)
    lg = gibbs._apply_dead_fallback(lg, lvl[2][:, j], gibbs._dead_predicate(lg))
    e = torch.exp(lg - lg.max(dim=-1, keepdim=True).values).double()
    return torch.cumsum(e / e.sum(dim=-1, keepdim=True), dim=-1)[0, 0]


def k2_compare(args, codes, kw, what):
    """``gibbs_select`` against ``gibbs_select_ref`` on the same inputs.
    Gumbel labels must be equal on every row; cdf labels on every row but
    those where the twin's float64 CDF lies within K2_TIE of u between the
    two labels (each listed with its |u - cdf|); the gathered mean and
    variance must equal the twin's wherever the labels do.  Returns the
    row of findings and the kernel's labels."""
    import torch
    from kde_tpu_torch.ops import gibbs_select
    got = gibbs_select.gibbs_select(*args, codes, **kw)
    _sync()
    want = gibbs_select.gibbs_select_ref(*args, codes, **kw)
    same = got[2] == want[2]
    bad = (~same).nonzero().tolist()
    if bad and (kw["u"] is None or len(bad) > K2_MAX_TIES):
        raise AssertionError(f"gibbs_select ({what}): {len(bad)} labels off "
                             "the twin's")
    ties = []
    for bi, ci, jj in bad:
        slab = args[3][bi, args[4][jj]]
        zk = _k2_index(slab, got[2][bi, ci, jj])
        zt = _k2_index(slab, want[2][bi, ci, jj])
        cdf = _twin_cdf(args, codes, bi, ci, jj)
        u = float(kw["u"][bi, ci, jj])
        gap = float((cdf[min(zk, zt):max(zk, zt)] - u).abs().max())
        if gap > K2_TIE:
            raise AssertionError(f"gibbs_select ({what}): row {bi, ci, jj} "
                                 f"takes {zk}, the twin {zt}, |u - cdf| "
                                 f"{gap}")
        ties.append(gap)
    keep = same[..., None].expand_as(got[0])
    err = max(float((g - w)[keep].abs().max()) if bool(keep.any()) else 0.0
              for g, w in zip(got[:2], want[:2]))
    if err != 0.0:
        raise AssertionError(f"gibbs_select ({what}): gathered stats "
                             f"{err} off the twin's at equal labels")
    return dict(rows=same.numel(), label_mismatches=len(bad),
                cdf_ties=ties, max_abs_err=err), got[2]


def k2_bound_ms(args, codes, kw, sms, clock_hz):
    """The least time an H100 could take for one ``gibbs_select`` call,
    counting what these inputs need.  Per (row, candidate) pair with k
    active dims: k divisions (one reciprocal each) and the dead test's exp
    on the SFU, 5k + 5 FP32 operations (difference, square, scale, log
    add, accumulate; weight, max, shift, sum), and the logs of c: with cov,
    k a pair on varied dims and one a row on a dim the call flags uniform
    (``kw["uniform"]``, as chain_bound_ms and k6_bound_ms count); without
    cov c is the candidate's own bandwidth, which no row changes, so one a
    (set, density, candidate) on varied dims and one a (set, density) on
    uniform ones.  gumbel takes two logs and no exp but on the rows below
    log(1e-99) (the dead test's sum), 4 more FP32 operations and the
    counter generator's integer work (THREEFRY_INT_OPS a block, a block
    for two float32 candidates or one float64, WORD_INT_OPS a float32
    word) on 64 INT32 lanes an SM.  cdf's scan is not counted (as
    chain_bound_ms: it reuses the exps the sum needs, over the one chunk
    that the chunk sums point to).  SFU at 16 a clock an SM, FP32 on 128
    lanes an SM; bytes (the level, mu, cov and u read once, the outputs
    written once) at 3.35 TB/s."""
    lm, lb, lw, lp, js, mu, cov, act = args
    b, dn, w, d = lm.shape
    c, n_js, item = mu.shape[1], len(js), lm.element_size()
    slabs = b * n_js
    k = int(act[:, list(js)].sum()) / slabs            # active dims a row
    uni = kw.get("uniform")
    ku = 0.0                      # uniform active dims a row, on average
    if uni is not None:
        ku = int((act & uni.bool())[:, list(js)].sum()) / slabs
    pairs, rows = slabs * c * w, slabs * c
    logs = (pairs * (k - ku) + rows * ku if cov is not None
            else slabs * (w * (k - ku) + ku))
    int32 = 0.0
    if kw["u"] is None:
        dead = float(_k2_dead_rows(args, codes)) * w   # pairs of dead rows
        sfu, fp32 = pairs * (k + 2) + logs + dead, pairs * (5 * k + 9)
        int32 = pairs * (THREEFRY_INT_OPS / 2 + WORD_INT_OPS if item == 4
                         else THREEFRY_INT_OPS + 4)
    else:
        sfu, fp32 = pairs * (k + 1) + logs, pairs * (5 * k + 5)
    nbytes = (n_js * b * w * (2 * d + 2) * item + b * c * d * item
              * (2 if cov is not None else 1) + b * c * n_js * (2 * d * item + 8)
              + (b * c * n_js * item if kw["u"] is not None else b * 16))
    times = {"operations": max(sfu / (SFU_EX2_PER_CLK * sms * clock_hz),
                               fp32 / (FP32_LANES_PER_CLK * sms * clock_hz),
                               int32 / (INT32_LANES_PER_CLK * sms * clock_hz)),
             "bytes": nbytes / HBM_BYTES}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def _k2_dead_rows(args, codes):
    """Rows of a ``gibbs_select`` stage whose max logit lies below
    log(1e-99), where the gumbel draw takes the dead test's sum (by the
    twin's logits, one density at a time)."""
    import torch
    from kde_tpu_torch.ops import gibbs, gibbs_select
    lm, lb, lw, lp, js, mu, cov, act = args
    stage = gibbs._Stage(tuple(js), mu, cov, None, act, act.cpu().numpy(),
                         gibbs_select.diffop_of(codes))
    thr = torch.tensor(gibbs_select.LOG_DEAD, dtype=mu.dtype)
    return sum(int((stage.logits(j, (lm, lb, lw, lp)).max(dim=-1).values
                    < thr.to(mu.device)).sum()) for j in js)


def k2_cases(gibbs_select):
    """Phase 3d's cases for ``gibbs_select`` (a module, whose layout
    constants set the edge widths): name -> (b, c, dn, w, d, js, dtype,
    cov, codes, mode, extras)."""
    import torch
    f32, f64 = torch.float32, torch.float64
    n = N_SLICE
    # name: (b, c, dn, w, d, js, dtype, cov, codes, mode, extras)
    cases = {
        "leaf sweep cdf": (1, n, 2, n, 2, (0,), f32, True, (0, 0), "cdf", {}),
        "leaf sweep gumbel": (1, n, 2, n, 2, (1,), f32, True, (0, 0),
                              "gumbel", {}),
        "leaf cond cdf": (1, n, 2, n, 2, (0, 1), f32, False, (0, 0), "cdf",
                          {}),
        "leaf cond gumbel": (1, n, 2, n, 2, (0, 1), f32, False, (0, 0),
                             "gumbel", {}),
        "leaf sweep cdf uniform": (1, n, 2, n, 2, (0,), f32, True, (0, 0),
                                   "cdf", dict(uniform=True)),
        "leaf cond cdf uniform": (1, n, 2, n, 2, (0, 1), f32, False,
                                  (0, 0), "cdf", dict(uniform=True)),
        "f64 replay": (1, SERVE_CHAINS, 2, 2000, 2, (0, 1), f64, False,
                       (0, 0), "cdf", {}),
        "f64 replay sweep": (1, SERVE_CHAINS, 2, 2000, 2, (1,), f64, True,
                             (0, 0), "cdf", {}),
        "circular cdf": (1, 4000, 2, n, 1, (0,), f32, True, (1,), "cdf", {}),
        "circular gumbel": (1, 4000, 2, n, 1, (0, 1), f32, False, (1,),
                            "gumbel", {}),
        "se2 cdf": (1, 4000, 2, n, 3, (1,), f32, True, (0, 0, 1), "cdf", {}),
        "se2 gumbel": (1, 4000, 2, n, 3, (0, 1), f32, False, (0, 0, 1),
                       "gumbel", {}),
        "pad dead cdf": (2, 512, 2, 1000, 2, (0, 1), f32, False, (0, 0),
                         "cdf", dict(pad=37, dead=5, mixed=True)),
        "pad dead gumbel": (2, 512, 2, 1000, 2, (0, 1), f32, True, (0, 0),
                            "gumbel", dict(pad=37, dead=5, mixed=True)),
    }
    for d in range(1, 9):
        cases[f"d={d} cdf"] = (2, 256, 2, 64, d, (0, 1), f32, d % 2 == 0,
                               (0,) * d, "cdf", dict(mixed=d > 1))
        cases[f"d={d} gumbel f64"] = (1, 256, 2, 64, d, (1,), f64, True,
                                      (0,) * d, "gumbel", {})
    for w in (gibbs_select.WARP_MAX_WIDTH, gibbs_select.WARP_MAX_WIDTH + 1):
        for dt in (f32, f64):
            for mode in ("cdf", "gumbel"):
                cases[f"w={w} {str(dt)[-7:]} {mode}"] = (
                    1, 512, 2, w, 2, (0,), dt, True, (0, 0), mode, {})
    # the shared-memory cache's edge: (w + 4d) itemsize + d <= CACHE_MAX_BYTES
    for dt in (f32, f64):
        item = 4 if dt == f32 else 8
        edge = (gibbs_select.CACHE_MAX_BYTES - 2) // item - 8
        for w in (edge, edge + 1):
            cases[f"w={w} {str(dt)[-7:]} cache edge"] = (
                1, 64, 2, w, 2, (0, 1), dt, False, (0, 0), "cdf", {})
    cases.update(k2_tile_cases(gibbs_select))
    return cases


def k2_tile_cases(gibbs_select):
    """cdf's tile layout at its edges (k2_cases' tuples): widths at a
    chunk's edge (chunk - 1, chunk, chunk + 1, at one slot a chunk and at
    two), the threshold width WARP_MAX_WIDTH and one above, the rows of a
    launch at TILE_MIN_ROWS and one below (chains not a multiple of the
    tile's rows), the conditioning stage with padded and dead rows, and
    d = 1-8 and 17 in float32 and float64, bandwidths uniform and varied,
    cov on and off, circular codes."""
    import torch
    f32, f64 = torch.float32, torch.float64
    rmin = gibbs_select.TILE_MIN_ROWS
    c = rmin + 5                              # not a multiple of 16 or 8
    cases = {}
    for dt in (f32, f64):
        item = 4 if dt == f32 else 8
        slot = gibbs_select.launch_plan(4000, 2, item, rows=c).slot
        first = -(-(gibbs_select.WARP_MAX_WIDTH + 1) // slot) + 1
        mc = gibbs_select.MAX_CHUNKS
        for spc, k in ((1, first), (2, mc // 2 + mc // 8 + 1)):
            for w in (k * spc * slot - 1, k * spc * slot, k * spc * slot + 1):
                plan = gibbs_select.launch_plan(w, 2, item, rows=c)
                if (plan.layout, plan.chunk) != ("tiles", spc * slot):
                    raise AssertionError(f"k2 tile cases: w = {w} plans "
                                         f"{plan}")
                cases[f"tiles w={w} {str(dt)[-7:]} chunk edge"] = (
                    1, c, 2, w, 2, (0,), dt, True, (0, 0), "cdf", {})
    for w in (gibbs_select.WARP_MAX_WIDTH, gibbs_select.WARP_MAX_WIDTH + 1):
        cases[f"tiles w={w} width edge"] = (1, c, 2, w, 2, (1,), f32, True,
                                            (0, 0), "cdf", {})
    for rows in (rmin - 1, rmin):
        cases[f"tiles {rows} rows edge"] = (1, rows, 2, 3000, 2, (0,), f32,
                                            False, (0, 0), "cdf", {})
    cases["tiles pad dead cond"] = (2, rmin // 4 + 3, 2, 3000, 2, (0, 1),
                                    f32, False, (0, 0), "cdf",
                                    dict(pad=37, dead=5, mixed=True))
    cases["tiles pad dead cond uniform"] = (
        2, rmin // 4 + 3, 2, 3000, 2, (0, 1), f32, True, (0, 0), "cdf",
        dict(pad=37, dead=5, mixed=True, uniform=True))
    for d in list(range(1, 9)) + [17]:
        dt = f32 if d % 2 else f64
        codes = tuple(int(d > 1 and k == d - 1) for k in range(d))
        cases[f"tiles d={d} {str(dt)[-7:]}"] = (
            1, rmin // 2 + 3, 2, 1500, d, (0, 1), dt, d % 3 == 0, codes, "cdf",
            dict(uniform=d % 2 == 0, mixed=d > 1))
    return cases


def phase_gibbs_select(dev):
    """Phase 3d: the Gibbs selection kernel against its plain twin at the
    slice's shapes and at the edges of its layouts; the leaf stages timed
    (one call, 20 back-to-back) beside the twin, the bound and, for scale
    only, torch.multinomial over precomputed probabilities.  Returns the
    rows printed."""
    import torch
    from kde_tpu_torch.ops import gibbs_select
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = _sm_clock_hz()
    cases = k2_cases(gibbs_select)
    rows = {}
    for i, (name, (b, c, dn, w, d, js, dt, cov, codes, mode, ex)) in \
            enumerate(cases.items()):
        args, codes, kw = k2_inputs(SEED + 20 + i, dev, b, c, dn, w, d, js,
                                    dt, cov, codes, mode, **ex)
        row = k2_compare(args, codes, kw, name)[0]
        row.update(B=b, C=c, w=w, d=d, js=list(js), dtype=str(dt), mode=mode,
                   uniform=bool(ex.get("uniform")),
                   plan=gibbs_select.launch_plan(
                       w, d, args[0].element_size(), rows=b * c * len(js),
                       gumbel=mode == "gumbel")._asdict())
        if name.startswith("leaf"):
            call = functools.partial(gibbs_select.gibbs_select, *args, codes,
                                     **kw)
            row["ms"] = _cuda_ms(call)
            row["ms_inner20"] = _cuda_ms(call, inner=20)
            row["plain_ms"] = _cuda_ms(functools.partial(
                gibbs_select.gibbs_select_ref, *args, codes, **kw), reps=3)
            row["bound_ms"], row["bound_by"] = k2_bound_ms(
                args, codes, kw, sms, clock)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            probs = torch.rand((b * c * len(js), w), device=dev)
            row["multinomial_ms_for_scale"] = _cuda_ms(
                lambda: torch.multinomial(probs, 1))
        rows[name] = row
        print(f"gibbs_select ({name}): {json.dumps(row)}", flush=True)
        del args, kw
    return rows


def chain_inputs(seed, dev, dtype, n, d=2, b=1, dn=2, n_out=None,
                 n_iter=5, kinds=None, mask=None, far=False, select="cdf",
                 ragged=False):
    """``gibbs_chain``'s arguments for ``b`` sets of ``dn`` densities of
    ``n`` points (``ragged``: density j of n - j n // 3, so the narrower
    densities' levels are padded) in ``d`` dims, N(0.5 j + 0.1 i, I)
    (``far``: 100 j apart,
    so every selection after the roots is dead) with Silverman's bandwidth,
    circular dims (``kinds`` "c") on either side of pi; the host plan;
    ``n_out`` (default ``n``) chains whose uniform and normal streams come
    from a generator on the card seeded with ``seed``; ``mask [dn][d]``
    for every set or all dims.  ``select="gumbel"``: no uniforms, and the
    sets' counter seeds (``gibbs_chain``'s last two arguments) drawn after
    the normals."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import gibbs
    rng = np.random.default_rng(seed)
    kinds = kinds or "e" * d
    circ = np.array([k == "c" for k in kinds])
    h = float(1.06 * n ** -0.2)
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    sets = []
    for i in range(b):
        dens = []
        for j in range(dn):
            nj = n - j * (n // 3) if ragged else n
            x = (rng.normal(size=(d, nj)) + (100.0 if far else 0.5) * j
                 + 0.1 * i)
            x[circ] = _wrap(np.pi - 0.2 + 0.4 * j + 0.1 * i
                            + 0.1 * rng.normal(size=(int(circ.sum()), nj)))
            dens.append(kt.kde(x.astype(np_dt), [h] * d, device=dev,
                               dtype=dtype))
        sets.append(dens)
    n_out = n_out or n
    plans = gibbs._stack_plans([gibbs._get_plan(ds, n_out, dtype, dev, "host")
                                for ds in sets])
    bu, bn = gibbs._stream_sizes(dn, d, plans.n_levels, n_iter)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = None
    if select == "cdf":
        u = torch.rand((b, n_out, bu), generator=gen, dtype=dtype,
                       device=dev)
    nrm = torch.randn((b, n_out, bn), generator=gen, dtype=dtype, device=dev)
    m = torch.ones((b, dn, d), dtype=torch.bool, device=dev)
    if mask is not None:
        m = torch.as_tensor(np.asarray(mask, dtype=bool), device=dev
                            )[None].expand(b, dn, d).contiguous()
    args = (u, nrm, plans, m, n_iter, True,
            tuple(int(k == "c") for k in kinds))
    if select == "cdf":
        return args
    seeds = torch.randint(0, 1 << 32, (b, 2), generator=gen,
                          dtype=torch.int64, device=dev)
    return args + ("gumbel", seeds)


def _set_of(args, i):
    """Set ``i`` of ``gibbs_chain``'s arguments, alone."""
    from kde_tpu_torch.ops import gibbs
    u, nrm, plans, m, n_iter, ent, codes = args[:7]
    one = gibbs._SetPlans(*(getattr(plans, f)[i:i + 1]
                            for f in gibbs._PLAN_TENSORS),
                          plans.offsets, plans.n_levels,
                          plans.lvl_uniform[i:i + 1])
    rest = args[7:8] + tuple(x[i:i + 1] for x in args[8:])
    return (None if u is None else u[i:i + 1], nrm[i:i + 1], one,
            m[i:i + 1], n_iter, ent, codes) + rest


def _chain_tie_gap(args, bi, ci, level):
    """The smallest |u - cdf| of the twin's float64 CDFs over the stages of
    ``level`` (0-based) of chain (set ``bi``, chain ``ci``), by
    ``ops/gibbs.py``'s own steps; infinite for the final draw (no
    selection)."""
    import torch
    from kde_tpu_torch.ops import gibbs, gibbs_chain, gibbs_select
    u, nrm, plans, m, n_iter, ent, codes = _set_of(args, bi)
    if level >= plans.n_levels:
        return float("inf")
    dn = m.shape[1]
    per_level, stages, gaps = 1 + n_iter * dn, [0], []

    def choose(stage, lvl):
        if stages[0] // per_level == level:
            for jj, j in enumerate(stage.js):
                lg = stage.logits(j, lvl)
                lg = gibbs._apply_dead_fallback(lg, lvl[2][:, j],
                                                gibbs._dead_predicate(lg))
                e = torch.exp(lg - lg.max(dim=-1, keepdim=True).values
                              ).double()
                cdf = torch.cumsum(e / e.sum(dim=-1, keepdim=True), dim=-1)
                gaps.append(float((cdf - stage.u[..., jj:jj + 1].double())
                                  .abs().min()))
        stages[0] += 1
        mean, var, label = gibbs_select.gibbs_select_ref(
            *lvl, stage.js, stage.mu, stage.cov, stage.active, codes,
            u=stage.u)
        return [(mean[:, :, i], var[:, :, i], label[:, :, i])
                for i in range(len(stage.js))]
    gibbs._run_chain(u[:, ci:ci + 1], nrm[:, ci:ci + 1], plans, m, n_iter,
                     ent, "cdf", hooks=gibbs_chain.hooks_of(codes),
                     choose=choose)
    return min(gaps)


def chain_compare(args, what, kernel=None, want=None):
    """``gibbs_chain`` (or the module ``kernel``'s, e.g. a parent
    checkout's) against ``gibbs_chain_ref`` on the same inputs (or
    ``want``, the twin's outputs already drawn): the share of chains whose
    per-level labels and points are equal.  Gumbel (``args[7]``) must be
    equal on every chain; for cdf a chain that differs is listed with its
    first differing level and that level's float64 tie gap
    (_chain_tie_gap), which must be within K2_TIE of u (a CDF tie), and at
    most K2_MAX_TIES chains a case may differ.  Returns the row of
    findings and the kernel's outputs."""
    from kde_tpu_torch.ops import gibbs_chain
    got = (kernel or gibbs_chain).gibbs_chain(*args)
    _sync()
    if want is None:
        want = gibbs_chain.gibbs_chain_ref(*args)
    labels_same = (got[2] == want[2]).all(dim=-1).all(dim=-1)
    same = labels_same & (got[0] == want[0]).all(dim=-1)
    bad = (~same).nonzero().tolist()
    gumbel = args[7:8] == ("gumbel",)
    if len(bad) > (0 if gumbel else K2_MAX_TIES):
        raise AssertionError(f"gibbs_chain ({what}): {len(bad)} chains off "
                             "the twin's")
    listed = []
    for bi, ci in bad:
        lv = (got[2][bi, ci] != want[2][bi, ci]).any(dim=-1).nonzero()
        level = int(lv[0]) if len(lv) else args[2].n_levels
        gap = _chain_tie_gap(args, bi, ci, level)
        listed.append(dict(set=bi, chain=ci, level=level, tie_gap=gap))
        if gap > K2_TIE:
            raise AssertionError(f"gibbs_chain ({what}): chain {bi, ci} "
                                 f"differs from level {level}, tie gap {gap}")
    err = float((got[0] - want[0])[labels_same].abs().max()) \
        if bool(labels_same.any()) else 0.0
    return dict(chains=same.numel(), same_share=float(same.double().mean()),
                differing=listed, max_abs_err=err), got


def chain_bound_ms(args, sms, clock_hz):
    """The least time an H100 could take for one ``gibbs_chain`` call,
    counting what these inputs need: per selection of density j at level
    l (1 + n_iter a chain) and per candidate, k IEEE divisions (a
    reciprocal each on the SFU), k logs or, where the level's bandwidth is
    uniform in a dim, one log a selection, and 5k + 5 FP32 operations
    (difference, square, scale, log add, accumulate; weight, max, shift,
    sum), k the active dims; cdf adds an exp (the scan to the label reuses
    the exps the sum needs); gumbel (``args[7]``) instead two logs, one
    FP32 operation more, and the counter generator's integer work
    (THREEFRY_INT_OPS a block, a block for two float32 candidates or one
    float64, WORD_INT_OPS a float32 word) on 64 INT32 lanes an SM; the
    dead test's sum on rows below log(1e-99) is left out (no keyed row of
    these cells comes near it), which keeps the bound a lower one.  SFU at
    16 a clock an SM, FP32 on 128 lanes an SM; bytes (the plan and the
    streams read once, points and labels written once) at 3.35 TB/s."""
    u, nrm, plans, m, n_iter, ent, codes = args[:7]
    gumbel = args[7:8] == ("gumbel",)
    b, c = nrm.shape[:2]
    dn, d = m.shape[1:]
    mi = m.int()
    act = (m & (mi.sum(dim=1, keepdim=True) - mi > 0)).cpu().numpy()
    uni = plans.lvl_uniform.bool().cpu().numpy()
    sfu = fp32 = int32 = 0.0
    sel = (1 + n_iter) * c
    item = nrm.element_size()
    per_int = (THREEFRY_INT_OPS / 2 + WORD_INT_OPS if item == 4
               else THREEFRY_INT_OPS + 4)
    for l, (o, w) in enumerate(plans.offsets):
        for j in range(dn):
            k = act[:, j].sum(axis=-1).astype(float)               # [B]
            ku = (act[:, j] & uni[:, j, l]).sum(axis=-1).astype(float)
            sfu += float((sel * w * (2 * k + (2 if gumbel else 1) - ku)
                          + sel * ku).sum())
            fp32 += float((sel * w * (5 * k + (6 if gumbel else 5))).sum())
            int32 += b * sel * w * per_int if gumbel else 0.0
    nbytes = sum(getattr(plans, f).nbytes for f in
                 ("lvl_mean", "lvl_bw", "lvl_logw", "lvl_perm")) \
        + (b * 16 if u is None else u.nbytes) + nrm.nbytes \
        + b * c * (d * item + 8 * dn * (plans.n_levels + 1))
    times = {"operations": max(sfu / (SFU_EX2_PER_CLK * sms * clock_hz),
                               fp32 / (FP32_LANES_PER_CLK * sms * clock_hz),
                               int32 / (INT32_LANES_PER_CLK * sms
                                        * clock_hz)),
             "bytes": nbytes / HBM_BYTES}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def dn_sum(terms, fastest):
    """``terms [..., dn]`` summed over the last axis in the order the chain
    kernel takes (csrc/gibbs_chain.cu's ``dn_sum``, torch's CUDA reduction
    order): off the fastest-striding dim (``fastest`` False), four
    accumulators (term j into j % 4), then ((a0 + a1) + a2) + a3; on it,
    last_pow2(dn) lanes (lane t: terms t and t + lanes), then a tree at
    offsets lanes / 2, ..., 1."""
    dn, zero = terms.shape[-1], terms.new_zeros(terms.shape[:-1])
    t = lambda j: terms[..., j]
    if not fastest:
        acc = [zero] * 4
        for j in range(dn):
            acc[j % 4] = acc[j % 4] + t(j)
        return ((acc[0] + acc[1]) + acc[2]) + acc[3]
    lanes = 1 << (dn.bit_length() - 1)
    v = [(((zero + t(i)) + (zero + t(i + lanes) if i + lanes < dn else zero))
          + zero) + zero for i in range(lanes)]
    o = lanes // 2
    while o:
        for i in range(o):
            v[i] = v[i] + v[i + o]
        o //= 2
    return v[0]


def _sum_order_probe(dev):
    """The share of entries of torch's ``.sum`` over the density axis equal
    to :func:`dn_sum`'s order, float32, at dn = 3, 5 and 8: the
    reduction off the fastest-striding dim for ``[B, C, dn, d].sum(dim=2)``
    with d > 1, on it with d = 1, for the dim-k slices the hooked sums
    take and for the fresh ``[B, C, dn]`` products the hooked means sum."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    out = {}
    for shape in ((1, 7, 3, 1), (1, 20000, 3, 1), (1, 2000, 3, 2),
                  (4, 5000, 3, 3), (1, 256, 5, 1), (1, 256, 5, 2),
                  (1, 256, 8, 1), (1, 256, 8, 3), (2, 300, 3, 1)):
        x = torch.rand(shape, generator=gen, device=dev) * torch.exp(
            8 * torch.rand(shape, generator=gen, device=dev))
        row = {"dim2": float((x.sum(dim=2) == dn_sum(
            x.movedim(2, -1), shape[3] == 1)).double().mean())}
        if shape[3] > 1:
            xs = x[..., 1]
            row["slice"] = float((xs.sum(dim=-1) == dn_sum(xs, True))
                                 .double().mean())
            xc = xs * 1.0
            row["fresh"] = float((xc.sum(dim=-1) == dn_sum(xc, True))
                                 .double().mean())
        out[str(shape)] = row
    return out


# phase 3e's timed rows beyond the slice and serve: the bench headline's
# shape (bench.py:37-40, 6 sets of 1,000 chains over 2 x 1,000), phase 7's
# batched product (4 sets of 20,000 chains over 2 x 20,000) and 1,024
# chains over 2 x 10,000, the fewest chains the launch plan stages
K3_TIMED = {"headline": (None, 1000, dict(b=6)),
            "batched": (None, N_SLICE, dict(b=BATCH_SETS)),
            "switch": (None, 10_000, dict(n_out=1024))}

# phase 3e's gumbel cases: name: (dtype, n, kwargs of chain_inputs), each
# run on every layout that takes it (the warp and block layouts and, for
# float32 at d <= 3, the staged one) against one draw of the twin; the
# K3_GUMBEL_TIMED ones also timed on the plan's layout
K3_GUMBEL = {
    "gumbel slice": ("f32", N_SLICE, {}),
    "gumbel serve": ("f32", N_SERVE, dict(n_out=SERVE_CHAINS)),
    "gumbel headline": ("f32", 1000, dict(b=6)),
    "gumbel batched": ("f32", N_SLICE, dict(b=BATCH_SETS)),
    "gumbel f64": ("f64", 2000, dict(n_out=400, n_iter=3)),
    "gumbel f64 wide": ("f64", 8000, dict(n_out=300, n_iter=2)),
    "gumbel circular": ("f32", 5000, dict(d=1, kinds="c")),
    "gumbel se2": ("f32", 5000, dict(d=3, kinds="eec")),
    "gumbel ragged dn 3": ("f32", 3000, dict(dn=3, ragged=True, n_iter=2,
                                             mask=[[1, 0], [1, 1], [0, 1]])),
    "gumbel dead rows": ("f32", 500, dict(far=True)),
    "gumbel d=5": ("f32", 1000, dict(d=5, n_out=512, n_iter=2)),
}
K3_GUMBEL_TIMED = ("gumbel slice", "gumbel serve", "gumbel headline",
                   "gumbel batched")


@contextlib.contextmanager
def _forced_layout(layout):
    """gibbs_chain launched on ``layout`` whatever its launch plan says."""
    from kde_tpu_torch.ops import gibbs_chain
    saved = gibbs_chain.launch_plan
    gibbs_chain.launch_plan = lambda *a, **k: layout
    try:
        yield
    finally:
        gibbs_chain.launch_plan = saved


def _twin_by_set(args):
    """``gibbs_chain_ref`` of each set alone, stacked (a set's draw does
    not depend on the batch: its seed, chain indices and selection ids are
    its own), and the seconds it took; less memory than the batch at
    once."""
    import torch
    from kde_tpu_torch.ops import gibbs_chain
    _sync()
    t0 = time.perf_counter()
    outs = [gibbs_chain.gibbs_chain_ref(*_set_of(args, i))
            for i in range(args[1].shape[0])]
    _sync()
    return (tuple(torch.cat(parts) for parts in zip(*outs)),
            time.perf_counter() - t0)


def phase_gibbs_chain_gumbel(dev, sms, clock):
    """Phase 3e's gumbel cases (K3_GUMBEL): every layout that takes a case
    against the twin, which must be equal on every chain (labels at every
    level and points); the K3_GUMBEL_TIMED shapes timed (one call) on the
    plan's layout beside the twin (set by set, one call) and the bound.
    Returns the rows printed."""
    import torch
    from kde_tpu_torch.ops import gibbs_chain
    rows = {}
    for i, (name, (dt, n, kw)) in enumerate(K3_GUMBEL.items()):
        dtype = torch.float32 if dt == "f32" else torch.float64
        args = chain_inputs(SEED + 90 + i, dev, dtype, n, select="gumbel",
                            **kw)
        d = args[3].shape[2]
        w = max(w for _, w in args[2].offsets)
        want, plain_s = _twin_by_set(args)
        row = dict(dtype=str(dtype), n=n, chains=args[1].shape[1],
                   sets=args[1].shape[0], levels=args[2].n_levels,
                   layout=gibbs_chain.launch_plan(args[1].shape[1], w, dtype,
                                                  d), layouts={})
        lays = ["warp", "block"] + (["staged"] if dt == "f32" and d <= 3
                                    else [])
        for lay in lays:
            with _forced_layout(lay):
                found, _ = chain_compare(args, f"{name} {lay}", want=want)
            row["layouts"][lay] = found["same_share"]
            row["max_abs_err"] = max(row.get("max_abs_err", 0.0),
                                     found["max_abs_err"])
        row["same_share"] = min(row["layouts"].values())
        row["differing"] = []
        if name in K3_GUMBEL_TIMED:
            row["ms"] = _cuda_ms(functools.partial(gibbs_chain.gibbs_chain,
                                                   *args))
            row["plain_ms"] = 1e3 * plain_s
            row["bound_ms"], row["bound_by"] = chain_bound_ms(args, sms,
                                                              clock)
            row["bound_share"] = row["bound_ms"] / row["ms"]
        rows[name] = row
        print(f"gibbs_chain ({name}): {json.dumps(row)}", flush=True)
        del args, want
    return rows


def phase_gibbs_chain(dev):
    """Phase 3e: the chain kernel against its plain twin on the card:
    float64 replay streams at a small size and at the slice, keyed float32
    cdf at the slice (20,000 chains) and at serve (256 chains over
    2 x 50,000), circular, SE(2), a partial-dim mask, dead rows, B = 4
    sets and one of them drawn alone, dn = 3 with n_iter 0, 1 and 5,
    d = 1..8, a float64 case on the block layout, the headline's, the
    batched product's and the fewest chains the plan stages (K3_TIMED);
    the share of chains equal to the twin's, the differing ones listed
    with their tie gaps.  The slice, serve and K3_TIMED calls are timed
    (one call) beside the twin and the bound (chain_bound_ms).  Then the
    gumbel cases (phase_gibbs_chain_gumbel).  Returns the rows printed."""
    import torch
    from kde_tpu_torch.ops import gibbs_chain
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = _sm_clock_hz()
    f32, f64 = torch.float32, torch.float64
    order = _sum_order_probe(dev)
    print(f"gibbs_chain sum order over the densities (share equal to "
          f"dn_sum's): {json.dumps(order)}", flush=True)
    if min(v for r in order.values() for v in r.values()) < 1.0:
        raise AssertionError("torch sums over the densities in another "
                             "order than the chain kernel")
    # name: (dtype, n, kwargs of chain_inputs)
    cases = {
        "replay f64 small": (f64, 500, dict(n_out=400, n_iter=3)),
        "replay f64 slice": (f64, N_SLICE, {}),
        "keyed f32 slice": (f32, N_SLICE, {}),
        "keyed f32 serve": (f32, N_SERVE, dict(n_out=SERVE_CHAINS)),
        "f64 block layout": (f64, 8000, dict(n_out=300, n_iter=2)),
        "circular": (f32, 5000, dict(d=1, kinds="c")),
        "se2": (f32, 5000, dict(d=3, kinds="eec")),
        "partial mask": (f32, 2000, dict(dn=3, mask=[[1, 0], [1, 1],
                                                     [0, 1]])),
        "dead rows": (f32, 500, dict(far=True)),
        "B=4": (f32, 5000, dict(b=4)),
    }
    for it in (0, 1, 5):
        cases[f"dn=3 n_iter={it}"] = (f32, 2000, dict(dn=3, n_iter=it))
    for d in range(1, 9):
        cases[f"d={d}"] = (f32, 1000, dict(d=d, n_out=512, n_iter=2))
    cases.update(K3_TIMED)
    rows = {}
    for i, (name, (dt, n, kw)) in enumerate(cases.items()):
        dt = dt or f32
        args = chain_inputs(SEED + 60 + i, dev, dt, n, **kw)
        row, got = chain_compare(args, name)
        w = max(w for _, w in args[2].offsets)
        row.update(dtype=str(dt), n=n, chains=args[1].shape[1],
                   sets=args[1].shape[0], levels=args[2].n_levels,
                   layout=gibbs_chain.launch_plan(args[1].shape[1], w, dt,
                                                  args[3].shape[2]))
        if name == "B=4":
            alone = gibbs_chain.gibbs_chain(*_set_of(args, 2))
            row["set2_alone_equal"] = all(
                torch.equal(a[0], g[2]) for a, g in zip(alone, got))
            if not row["set2_alone_equal"]:
                raise AssertionError("gibbs_chain: set 2 drawn in the batch "
                                     "differs from its draw alone")
        if name in ("keyed f32 slice", "keyed f32 serve") or name in K3_TIMED:
            call = functools.partial(gibbs_chain.gibbs_chain, *args)
            row["ms"] = _cuda_ms(call)
            row["plain_ms"] = _cuda_ms(functools.partial(
                gibbs_chain.gibbs_chain_ref, *args), reps=1)
            row["bound_ms"], row["bound_by"] = chain_bound_ms(args, sms,
                                                              clock)
            row["bound_share"] = row["bound_ms"] / row["ms"]
        rows[name] = row
        print(f"gibbs_chain ({name}): {json.dumps(row)}", flush=True)
        del args, got
    rows.update(phase_gibbs_chain_gumbel(dev, sms, clock))
    return rows


def k4_inputs(r, n, dtype, data, dev, seed=SEED):
    """The arguments of loo_search for ``r`` rows of ``n`` points as
    ksize_rows forms them (uniform weights, the sort bracket), and the
    twin's route."""
    import torch
    from kde_tpu_torch.ops import loocv
    rng = np.random.default_rng(seed + 70 + r + n)
    x = rng.normal(size=(r, n))
    if data == "refit":
        x = 0.25 + np.sqrt(0.5) * x
    dt = getattr(torch, dtype)
    rows = torch.as_tensor(x, dtype=dt, device=dev)
    w = torch.full((n,), 1.0 / n, dtype=dt, device=dev)
    lo, hi = loocv._slices_on(n, dev)
    base, ax, bx, cx = loocv.bracket_rows(rows, lo, hi)
    return ((rows, w, (base ** 2).contiguous(), ax, bx, cx),
            loocv.select_loo_impl(n, dt), (lo, hi))


@contextlib.contextmanager
def _k4_on_twin():
    """ksize_rows with its search on K4's plain twin (the parent's Python
    loop over K1 or the dense probes); a reference, not counted."""
    from kde_tpu_torch.ops import loo_search, loocv
    saved = loocv.loo_search
    loocv.loo_search = loo_search.loo_search_ref
    try:
        with _uncounted():
            yield
    finally:
        loocv.loo_search = saved


def k4_fp64_per_pair(so):
    """FP64 pipe instructions (DADD, DMUL, DFMA, DSETP, DMNMX) of one probe
    term that every pair runs, from the SASS of the never-launched kernel
    loo_pair_probe, which holds the inner loop's pair_term once:
    those before its first EXIT and outside a block that a conditional
    branch skips (the exp's out-of-range handling), and the count with
    those blocks.  Returns (count, count with the skipped blocks, the
    listing's lines)."""
    import re
    from pathlib import Path
    from kde_tpu_torch.ops import tiled_eval
    tool = Path(tiled_eval._nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                         text=True, timeout=600, check=True)
    code, inside = [], False
    for line in res.stdout.splitlines():
        if "Function :" in line:
            inside = "loo_pair_probe" in line
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if inside and m:
            code.append((int(m.group(1), 16), m.group(2).strip()))
    skipped = set()
    for at, ins in code:
        m = re.match(r"@!?U?P[T0-9]+\s+BRA\s+(?:`\()?0x([0-9a-f]+)", ins)
        if m:
            skipped.update(a for a, _ in code
                           if at < a < int(m.group(1), 16))
    every = every_max = 0
    for at, ins in code:
        op = re.sub(r"^@!?U?P[T0-9]+\s+", "", ins).split()[0]
        if op == "EXIT":
            break
        if op.split(".")[0] in ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX"):
            every_max += 1
            every += at not in skipped
    if every == 0:
        raise AssertionError("no FP64 instruction found in loo_pair_probe")
    return every, every_max, [ins for _, ins in code]


def k4_bound_ms(args, probes, sms, clock_hz, fp64_per_pair):
    """The least time an H100 could take for the searches of loo_search,
    counting the pairs this run's data needs: every live pair (i != j, both
    weights positive) once for the nearest-neighbour shifts and once per
    probe of its row (``probes [R]``, from K4's trace).  float32: one ex2 a
    probe pair on the SFU (16 a clock per SM) or 4 FP32 instructions a
    probe pair and 3 a shift pair (difference, square, min) at 128 a clock
    per SM, whichever is longer; float64: ``fp64_per_pair`` FP64
    instructions a probe pair (from the SASS) and 3 a shift pair at 64 a
    clock per SM.  Bytes: rows, weights and brackets read once, the result
    written once, at 3.35 TB/s."""
    import torch
    rows, w = args[0], args[1]
    r, n = rows.shape
    live = int((w > 0).sum())
    pairs = live * (live - 1)
    probe_pairs = pairs * int(sum(probes))
    shift_pairs = pairs * r
    rate = sms * clock_hz
    if rows.dtype == torch.float32:
        ops = max(probe_pairs / (SFU_EX2_PER_CLK * rate),
                  (4 * probe_pairs + 3 * shift_pairs)
                  / (FP32_LANES_PER_CLK * rate))
    else:
        ops = ((fp64_per_pair * probe_pairs + 3 * shift_pairs)
               / (FP64_LANES_PER_CLK * rate))
    nbytes = rows.element_size() * (r * n + n + 5 * r)
    times = {"operations": ops, "bytes": nbytes / HBM_BYTES}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def probe_max_rel(trace, nloo, what):
    """Every probe ``(x, f)`` of a search's ``trace`` (loo_search.new_trace
    format) against ``nloo(x)``, the plain entropy at the same x: the
    non-finite values must be equal; returns the largest relative gap of
    the finite ones."""
    import torch
    x, f = trace[:, :, 0], trace[:, :, 1]
    probe_rel = 0.0
    for k in range(x.shape[1]):
        live = ~torch.isnan(x[:, k])
        if not bool(live.any()):
            break
        fw = nloo(torch.where(live, x[:, k], torch.ones_like(x[:, k])))
        fin = live & torch.isfinite(fw)
        torch.testing.assert_close(f[live & ~fin, k], fw[live & ~fin],
                                   rtol=0, atol=0, equal_nan=True,
                                   msg=f"{what}: non-finite probes")
        if bool(fin.any()):
            probe_rel = max(probe_rel, float(
                ((f[fin, k].double() - fw[fin].double()).abs()
                 / fw[fin].double().abs()).max()))
    return probe_rel


def k4_compare(args, impl, got, trace, what):
    """K4's picks ``got`` and ``trace`` against the twin on the same
    inputs: float64 at rtol K4_F64_RTOL; float32 every reported probe value
    within K4_PROBE_RTOL of the twin's entropy at the same x (non-finite
    values equal) and the pick within the final bracket, 2 K4_TOL
    relative (where two entropies lie within the float32 sums' noise the
    twin may compare them the other way).  Returns the row's numbers."""
    import torch
    from kde_tpu_torch.ops import loo_search
    with _uncounted():
        want = loo_search.loo_search_ref(*args, tol=K4_TOL, impl=impl)
        nloo = loo_search.make_nloo(args[0], args[2], args[1], impl, 1024)
        probe_rel = probe_max_rel(trace, nloo, what)
    rel = float(((got.double() - want.double()).abs()
                 / want.double().abs()).max())
    limit = K4_F64_RTOL if got.dtype == torch.float64 else 2 * K4_TOL
    if not rel <= limit or probe_rel > K4_PROBE_RTOL:
        raise AssertionError(f"{what}: picks {rel:.3g} apart (limit "
                             f"{limit}), probes {probe_rel:.3g}")
    probes = (~torch.isnan(trace[:, :, 0])).sum(dim=1)
    return dict(max_rel=rel, probe_max_rel=probe_rel,
                max_abs_err=float((got.double() - want.double()).abs().max()),
                probes=probes.tolist(), iterations=int(probes.max()) - 2,
                xmin=got.tolist()[:4], twin_xmin=want.tolist()[:4])


def phase_loo_search(dev, cases=None):
    """Phase 3f: K4 (loo_search, csrc/loo_search.cu) against its plain twin
    on the card at the main path's searches (K4_CASES): one launch a call,
    bitwise the same over repeated calls, k4_compare's limits; timed (one
    call, the wrapper's host work included) beside the bound (k4_bound_ms),
    the twin alone and ksize_rows on the twin (the parent's route: the
    Python golden loop over K1 or the dense probes), and ksize_rows on K4.
    No single PyTorch call runs a LOO golden search: library_ms is null.
    Returns the rows printed."""
    import torch
    from kde_tpu_torch.ops import loo_search, loocv
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = _sm_clock_hz()
    per_pair, per_pair_max, sass = k4_fp64_per_pair(loo_search.build())
    print(f"loo_search: {per_pair} FP64 instructions every float64 probe "
          f"pair runs, {per_pair_max} with the exp's out-of-range path "
          f"(SASS of loo_pair_probe: {json.dumps(sass[:90])})",
          flush=True)
    rows = {}
    for name, (r, n, dtype, data) in (cases or K4_CASES).items():
        args, impl, (lo, hi) = k4_inputs(r, n, dtype, data, dev)
        trace = loo_search.new_trace(args[0], K4_TOL)
        before = loo_search.LAUNCHES
        got = loo_search.loo_search(*args, tol=K4_TOL, impl=impl,
                                    trace=trace)
        again = [loo_search.loo_search(*args, tol=K4_TOL, impl=impl)
                 for _ in range(2)]
        _sync()
        launched = loo_search.LAUNCHES - before
        if launched != (3 if dev.type == "cuda" else 0):
            raise AssertionError(f"loo_search ({name}): {launched} launches "
                                 "for 3 calls")
        if not all(torch.equal(a, got) for a in again):
            raise AssertionError(f"loo_search ({name}): repeated calls "
                                 "differ")
        plan = loo_search.launch_plan(r, n, args[0].dtype, sms)
        row = dict(rows=r, n=n, dtype=dtype, twin_route=impl,
                   plan=plan._asdict(),
                   **k4_compare(args, impl, got, trace, name))
        search = functools.partial(loo_search.loo_search, *args, tol=K4_TOL,
                                   impl=impl)
        fit = functools.partial(loocv.ksize_rows, args[0], args[1], lo, hi,
                                tol=K4_TOL, impl=impl)
        with _uncounted():
            row["ms"] = _cuda_ms(search)
            row["ksize_rows_ms"] = _cuda_ms(fit)
            row["plain_ms"] = _cuda_ms(functools.partial(
                loo_search.loo_search_ref, *args, tol=K4_TOL, impl=impl),
                reps=2)
        with _k4_on_twin():
            row["parent_ms"] = _cuda_ms(fit, reps=2)
        row["bound_ms"], row["bound_by"] = k4_bound_ms(
            args, row["probes"], sms, clock, per_pair)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["library_ms"] = None
        row["launches_per_call"] = launched / 3
        rows[name] = row
        print(f"loo_search ({name}): {json.dumps(row)}", flush=True)
        del args, got, again, trace
    return rows


def k4_diag_split(rec, sms):
    """The split of one diag-build K4 call from its stamps ``rec``
    (uint64 [blocks, max_iters + 2, 8], csrc/loo_search.cu's K4_DIAG
    record): for the nearest-neighbour sweep, the first sweep (two probes
    a row) and the mean of the later sweeps, the means over the blocks
    that ran the sweep of its item compute, item fetch and idle time
    (between the golden step and the last item, less the compute), the
    barrier (the grid sync, or the row's barrier) and the slot reduction
    and update (the golden step before the items, the reduction and fold
    after the barrier), all in us; the sweep's wall (first start to last
    fold); the items each SM ran (max, mean, min over all ``sms`` SMs, and
    the SMs that ran none) and the busiest SM's compute.  ``span_us`` runs
    from the first block's start to the last block's fold."""
    ran = rec[:, :, 7] > 0
    parts = {"nn": [], "first": [], "later": []}
    t_min, t_max = None, None
    for s in np.nonzero(ran.any(axis=0))[0]:
        r = rec[ran[:, s], s].astype(np.int64)
        t = r[:, :5] - r[:, 0].min()
        busy, items, sm = r[:, 5], r[:, 6], r[:, 7] - 1
        per_sm = np.bincount(sm, weights=items, minlength=sms)
        row = dict(
            wall_us=float(t[:, 4].max()) / 1e3,
            compute_us=float(busy.mean()) / 1e3,
            fetch_idle_us=float((t[:, 2] - t[:, 1] - busy).mean()) / 1e3,
            barrier_us=float((t[:, 3] - t[:, 2]).mean()) / 1e3,
            update_us=float(((t[:, 1] - t[:, 0]) + (t[:, 4] - t[:, 3])
                             ).mean()) / 1e3,
            busiest_sm_compute_us=float(np.bincount(
                sm, weights=busy, minlength=sms).max()) / 1e3,
            items_per_sm_max=float(per_sm.max()),
            items_per_sm_mean=float(per_sm.mean()),
            items_per_sm_min=float(per_sm.min()),
            sms_without_items=int((per_sm == 0).sum()), blocks=len(r))
        parts["nn" if s == 0 else "first" if s == 1 else "later"].append(row)
        lo, hi = r[:, 0].min(), r[:, 4].max()
        t_min = lo if t_min is None else min(t_min, lo)
        t_max = hi if t_max is None else max(t_max, hi)
    out = {k: v[0] for k, v in parts.items() if k != "later" and v}
    later = parts["later"]
    out["later_sweeps"] = len(later)
    if later:
        out["later_mean"] = {k: float(np.mean([x[k] for x in later]))
                             for k in later[0]}
    out["span_us"] = float(t_max - t_min) / 1e3
    return out


def k4_diag_lib():
    """csrc/loo_search.cu built with -DK4_DIAG, and bound."""
    from kde_tpu_torch.ops import loo_search, tiled_eval
    return loo_search.bind(tiled_eval.nvcc_build(
        loo_search.SOURCE, [*loo_search.NVCC_FLAGS, "-DK4_DIAG"],
        "loo_search_k4_diag")[0])


def k4_plan(args, layout, sms):
    """The plan of ``layout`` for loo_search's ``args``: the grid plan, or
    the rows plan with no cap on N (``loo_search._rows_plan``; None where
    the row does not fit a block)."""
    from kde_tpu_torch.ops import loo_search
    if layout == "grid":
        return loo_search.GRID
    r, n = args[0].shape
    plan = loo_search._rows_plan(r, n, args[0].dtype, sms)
    return plan if plan.layout == "rows" else None


# the grid plan's blocks an SM at most: 2,048 threads an SM on sm_90, 256
# a block (csrc/loo_probe.cuh's kThreads)
K4_GRID_BLOCKS_PER_SM = 2048 // 256


def k4_diag_call(diag, args, plan, sms):
    """One call of the diag build ``diag`` on ``plan`` with a zeroed stamp
    buffer (a record for every block the launch can have; blocks that did
    not run leave theirs 0); returns (xmin, k4_diag_split of its
    stamps)."""
    import torch
    from kde_tpu_torch.ops import loo_search
    rows = args[0]
    r = rows.shape[0]
    iters = loo_search.max_iters(K4_TOL, rows.dtype)
    blocks = (r * plan.blocks_per_row if plan.layout == "rows" else
              K4_GRID_BLOCKS_PER_SM * sms)
    buf = torch.zeros(blocks * (iters + 2) * 8, dtype=torch.int64,
                      device=rows.device)
    diag.kde_loo_set_diag(buf.data_ptr())
    try:
        x = loo_search.launch(diag, *args, K4_TOL, plan=plan)
        _sync()
    finally:
        diag.kde_loo_set_diag(None)
    rec = buf.cpu().numpy().view(np.uint64).reshape(blocks, iters + 2, 8)
    return x, k4_diag_split(rec, sms)


K4_HOST_CALLS = 20        # --k4-diag: launches whose host time is averaged


def k4_diag(dev=None, names=K4_DIAG_CASES, plans=("grid", "rows"),
            sweep=True):
    """Where a K4 call's time goes on this card, at phase 3f's searches
    K4_DIAG_CASES, for each plan of ``plans`` (the grid plan, the parent's
    design; the rows plan): the release build's CUDA-event ms of one call
    (``_cuda_ms``) beside k4_bound_ms, the host us of one launch (the mean
    of K4_HOST_CALLS back to back, no sync between) and the diag build's
    split of the same call (k4_diag_split, its second call; its picks
    bitwise the release build's grid plan's); the nearest-neighbour
    sweep's ``update_us`` is the block's staging prologue.  Then
    k4_barriers and (``sweep``) k4_switch."""
    import torch
    from kde_tpu_torch.ops import loo_search
    dev = dev or torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = _sm_clock_hz()
    per_pair = k4_fp64_per_pair(loo_search.build())[0]
    print(f"k4 ptxas: {json.dumps(ptxas_table(loo_search.BUILD_LOG))}",
          flush=True)
    diag, lib = k4_diag_lib(), loo_search._load()
    for name in names:
        r, n, dtype, data = K4_CASES[name]
        args, impl, _ = k4_inputs(r, n, dtype, data, dev)
        trace = loo_search.new_trace(args[0], K4_TOL)
        want = loo_search.launch(lib, *args, K4_TOL, trace)
        probes = (~torch.isnan(trace[:, :, 0])).sum(dim=1).tolist()
        bound, by = k4_bound_ms(args, probes, sms, clock, per_pair)
        for layout in plans:
            plan = k4_plan(args, layout, sms)
            if plan is None:
                continue
            k4_diag_call(diag, args, plan, sms)
            got, split = k4_diag_call(diag, args, plan, sms)
            if not torch.equal(_bits(got), _bits(want)):
                raise AssertionError(f"k4 diag ({name}, {plan}): the picks "
                                     "differ from the grid plan's")
            ms = _cuda_ms(functools.partial(loo_search.launch, lib, *args,
                                            K4_TOL, plan=plan))
            diag_ms = _cuda_ms(functools.partial(loo_search.launch, diag,
                                                 *args, K4_TOL, plan=plan))
            _sync()
            t0 = time.perf_counter()
            for _ in range(K4_HOST_CALLS):
                loo_search.launch(lib, *args, K4_TOL, plan=plan)
            host_us = 1e6 * (time.perf_counter() - t0) / K4_HOST_CALLS
            _sync()
            row = dict(case=name, plan=plan._asdict(), rows=r, n=n,
                       dtype=dtype, ms=ms, diag_ms=diag_ms, host_us=host_us,
                       bound_ms=bound,
                       bound_by=by, bound_share=bound / ms, probes=probes,
                       **split)
            print(f"k4 diag: {json.dumps(row)}", flush=True)
    k4_barriers(dev, lib, diag)
    if sweep:
        k4_switch(dev, lib)
    print(_card())


# --k4-diag's barrier comparison: (rows, points, dtype) whose rows plan
# meets on a cluster, and whose blocks a cooperative launch also holds
K4_BARRIER_CASES = ((1, 100, "float32"), (2, 256, "float32"),
                    (12, 256, "float32"), (64, 256, "float32"),
                    (2, 256, "float64"))


def k4_barriers(dev, lib, diag, cases=K4_BARRIER_CASES):
    """The rows plan's two barriers at K4_BARRIER_CASES (N(0, 1) rows, as
    phase 3f's fit): the plan on its cluster and the same plan at the
    per-row counter, picks and probe traces bitwise equal; one call each
    between CUDA events (``_cuda_ms``, the wrapper included) in turns
    (cluster, counter, counter, cluster), and the diag build's mean later
    sweep on each (k4_diag_split)."""
    import torch
    from kde_tpu_torch.ops import loo_search
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for r, n, dtype in cases:
        args, _, _ = k4_inputs(r, n, dtype, "fit", dev)
        cl = k4_plan(args, "rows", sms)
        if cl is None or not cl.cluster:
            raise AssertionError(f"k4 barriers {r}x{n}: no cluster plan")
        plans = {"cluster": cl, "counter": cl._replace(cluster=False)}
        got, row = {}, dict(rows=r, n=n, dtype=dtype, plan=cl._asdict())
        for side, plan in plans.items():
            trace = loo_search.new_trace(args[0], K4_TOL)
            got[side] = (loo_search.launch(lib, *args, K4_TOL, trace, plan),
                         trace)
            later = k4_diag_call(diag, args, plan, sms)[1].get("later_mean",
                                                               {})
            row[f"{side}_later_sweep"] = {
                k: later.get(k) for k in ("wall_us", "compute_us",
                                          "barrier_us", "update_us")}
        if not all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(got["cluster"], got["counter"])):
            raise AssertionError(f"k4 barriers {r}x{n} {dtype}: the "
                                 "barriers' bits differ")
        for side in ("cluster", "counter", "counter", "cluster"):
            row.setdefault(f"{side}_ms", []).append(_cuda_ms(
                functools.partial(loo_search.launch, lib, *args, K4_TOL,
                                  plan=plans[side]), reps=9))
        row["counter_over_cluster"] = (min(row["counter_ms"])
                                       / min(row["cluster_ms"]))
        print(f"k4 barriers: {json.dumps(row)}", flush=True)


# --k4-diag's switch sweep: rows x points, float32 and float64
K4_SWITCH_ROWS = (1, 2, 3, 12)
K4_SWITCH_NS = (256, 512, 1024, 2048, 4096, 8192, 16384)


def k4_switch(dev, lib, rows_=K4_SWITCH_ROWS, ns=K4_SWITCH_NS):
    """The switch between K4's plans: at every rows x N of K4_SWITCH_ROWS x
    K4_SWITCH_NS, float32 and float64 (N(0, 1) rows, as phase 3f's fit),
    the grid plan and the rows plan (uncapped N, where the row fits a
    block) timed in turns (grid, rows, rows, grid), one call each between
    CUDA events (``_cuda_ms``, median of 3), their picks and probe traces
    bitwise equal; the rows plan's share of the grid plan's time."""
    import torch
    from kde_tpu_torch.ops import loo_search
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in ("float32", "float64"):
        for r in rows_:
            for n in ns:
                args, _, _ = k4_inputs(r, n, dtype, "fit", dev)
                plans = {"grid": loo_search.GRID,
                         "rows": k4_plan(args, "rows", sms)}
                row = dict(rows=r, n=n, dtype=dtype,
                           plan=None if plans["rows"] is None
                           else plans["rows"]._asdict())
                if plans["rows"] is None:
                    row["grid_ms"] = [_cuda_ms(functools.partial(
                        loo_search.launch, lib, *args, K4_TOL), reps=3)]
                    print(f"k4 switch: {json.dumps(row)}", flush=True)
                    continue
                got = {}
                for side, plan in plans.items():
                    trace = loo_search.new_trace(args[0], K4_TOL)
                    x = loo_search.launch(lib, *args, K4_TOL, trace, plan)
                    got[side] = (x, trace)
                row["bitwise_equal"] = all(
                    torch.equal(_bits(a), _bits(b))
                    for a, b in zip(got["grid"], got["rows"]))
                if not row["bitwise_equal"]:
                    raise AssertionError(f"k4 switch {r}x{n} {dtype}: the "
                                         "plans' bits differ")
                for side in ("grid", "rows", "rows", "grid"):
                    row.setdefault(f"{side}_ms", []).append(_cuda_ms(
                        functools.partial(loo_search.launch, lib, *args,
                                          K4_TOL, plan=plans[side]),
                        reps=3))
                row["rows_over_grid"] = (min(row["rows_ms"])
                                         / min(row["grid_ms"]))
                print(f"k4 switch: {json.dumps(row)}", flush=True)


# phase 3h: K7's cases, name -> (points in 2-D, dtype): phase 11a's
# search (N_KSIZE points, S = 1) and the full-width one (K7_BIG_N)
K7_BIG_N = 100_000
K7_CASES = {"11a f32": (N_KSIZE, "float32"), "11a f64": (N_KSIZE, "float64"),
            "100k f32": (K7_BIG_N, "float32"),
            "100k f64": (K7_BIG_N, "float64")}
K7_MAIN = "11a f32"      # the kernels line's K7 numbers
K7_SUM_RTOL = {"float64": 1e-12, "float32": K4_PROBE_RTOL}
# csrc/sharded_loo.cu's kernels, as a trace names them
K7_KERNEL_NAMES = ("stage_kernel", "nn_kernel", "sweep_kernel",
                   "golden_kernel")
# the kernels of the design before the fused sweep, for --k7-parent's split
K7_PARENT_KERNEL_NAMES = ("stage_kernel", "rows_kernel", "entropy_kernel",
                          "golden_kernel")


def k8_bound_ms(npts, d, dtype, slots):
    """K8's memory roofline: each depth reads the points and reads and
    writes the order once (``tree_build.launch_plan``'s ``bytes``), the
    slot arrays (means, variances, log weight, index) are written once for
    every slot, and so are the ``slots`` level entries, at 3.35 TB/s."""
    import torch
    from kde_tpu_torch.ops import tree_build
    entry = (2 * d + 1) * torch.empty((), dtype=dtype).element_size() + 8
    total = sum(r["bytes"] for n in npts
                for r in tree_build.launch_plan(n, d, dtype))
    total += sum(2 * n for n in npts) * entry + slots * entry
    return 1e3 * total / HBM_BYTES


def _plan_host_ms(dens, n_out, reps=10):
    """Median host milliseconds of one DeviceProductPlan build, synchronised
    before and after, and the profiler's count of its launch calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from kde_tpu_torch.ops import device_plan
    build = lambda: device_plan.DeviceProductPlan(dens, n_out, dens[0].dtype)
    build()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        build()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build()
        torch.cuda.synchronize()
    launches = sum("LaunchKernel" in e.name for e in prof.events())
    return float(np.median(times)), launches


def phase_tree_build(dev, n=N_SLICE, seed=SEED):
    """Phase 3i: K8 (``ops/tree_build.py``) at the star cells' shapes, two
    densities of ``n`` points, d = 2 and 3, float32: every plan array
    against the twin route's bit for bit, the build's CUDA-event time
    beside the twin's and the memory-roofline bound, and DeviceProductPlan
    on the host clock through K8 and through the twin route (the parent's
    eager build); ``--k8-routes`` times the routes against each other."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import device_plan, tree_build
    from kde_tpu_torch.ops.balltree import n_levels
    rng = np.random.default_rng(seed + 8)
    rows = {}
    kernel, eager = device_plan._kernel_arrays, device_plan._eager_arrays
    for d in (2, 3):
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
        dens = [kt.kde(f32(rng.normal(size=(d, n)) + 0.5 * j), [0.2] * d)
                for j in range(2)]
        sets, ns = [dens], (n, n)
        n_lv = n_levels(n, ns)
        got = kernel(sets, ns, n_lv, torch.float32)
        want = eager(sets, ns, n_lv, torch.float32)
        torch.cuda.synchronize()
        names = ("t_mean", "t_bw", "lvl_mean", "lvl_bw", "lvl_logw",
                 "lvl_perm", "lvl_uniform")
        mism = {k: int((g != x).sum()) for k, g, x in zip(names, got, want)
                if g.shape != x.shape or not torch.equal(g, x)}
        if mism:
            raise AssertionError(f"K8 2x{n} d={d}: arrays differ from the "
                                 f"twin route's: {mism}")
        ms = _cuda_ms(lambda: kernel(sets, ns, n_lv, torch.float32))
        ms20 = _cuda_ms(lambda: kernel(sets, ns, n_lv, torch.float32),
                        inner=20)
        plain = _cuda_ms(lambda: eager(sets, ns, n_lv, torch.float32))
        bound = k8_bound_ms(ns, d, torch.float32, got[4].numel())
        host, launches = _plan_host_ms(dens, n)
        device_plan._kernel_arrays = eager
        try:
            host_twin, launches_twin = _plan_host_ms(dens, n)
        finally:
            device_plan._kernel_arrays = kernel
        rows[f"2x{n} d{d}"] = dict(
            equal=True, ms=ms, ms_inner20=ms20, plain_ms=plain,
            bound_ms=bound, bound_by="memory", bound_share=bound / ms,
            plan_host_ms=host, plan_launches=launches,
            twin_plan_host_ms=host_twin, twin_plan_launches=launches_twin,
            launch_plan=[r["route"] for r in tree_build.launch_plan(
                n, d, torch.float32)])
        print(f"3i K8 tree_build 2x{n} d={d}: {json.dumps(rows[f'2x{n} d{d}'])}",
              flush=True)
    return rows


def k8_routes(dev=None, ns=(20_000, 100_000), dims=(2, 3),
              chunks=(1024, 2048, 4096), depths=range(4, 12)):
    """``--k8-routes``: K8's build of two densities of each of ``ns`` points
    (float32; float64 at the first), CUDA-event ms for every multi-block
    chunk in ``chunks`` and every depth ``k0`` at which the subtree launch
    takes over (the multi-block route above it) that one block's shared
    memory holds (``tree_build._launch_routes``): the measurements behind
    ``SUBTREE_MAX_WIDTH`` and ``CHUNK``.  Prints one JSON line."""
    import torch
    from kde_tpu_torch.ops import device_plan, tree_build
    from kde_tpu_torch.ops.balltree import n_levels
    dev = dev or torch.device("cuda")
    rng = np.random.default_rng(SEED + 9)
    out = {}
    cases = [(n, d, torch.float32) for n in ns for d in dims]
    cases.append((ns[0], dims[0], torch.float64))
    for n, d, dtype in cases:
        item = torch.empty((), dtype=dtype).element_size()
        ins = [tuple(torch.as_tensor(x, dtype=dtype, device=dev) for x in
                     (rng.normal(size=(1, n, d)),
                      rng.uniform(0.1, 1, size=(1, n, d)),
                      np.full((1, n), 1.0 / n)))
               for _ in range(2)]
        table = device_plan._level_table((n, n), n_levels(n, (n, n)), dev)
        row = {}
        for chunk in chunks:
            for k0 in depths:
                width = -(-n // (1 << k0))
                if (tree_build.subtree_smem(width, item)
                        > tree_build.SMEM_MAX_BYTES):
                    continue
                row[f"c{chunk}_k{k0}"] = _cuda_ms(
                    lambda: tree_build._launch_routes(
                        ins, dtype, 2 * n, table, [k0, k0], chunk))
        key = f"2x{n} d{d} {str(dtype)[6:]}"
        out[key] = row
        best = min(row, key=row.get)
        print(f"k8 routes {key}: best {best} {row[best]:.3f} ms; "
              f"{json.dumps(row)}", flush=True)
    print(json.dumps({"k8_routes": out}))


def k8_main():
    """``--k8``: build K8 and run phase 3i alone."""
    import torch
    from kde_tpu_torch.ops import tree_build
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py --k8 needs a CUDA card")
    t0 = time.perf_counter()
    so = tree_build.build()
    print(f"device: {_card()} | torch {torch.__version__} | build tree_build "
          f"{time.perf_counter() - t0:.2f} s -> {os.path.relpath(so)}; "
          f"ptxas per kernel: {json.dumps(ptxas_table(tree_build.BUILD_LOG))}",
          flush=True)
    print(json.dumps({"tree_build": phase_tree_build(torch.device("cuda"))}))


def k7_inputs(n, dtype, dev, seed=SEED):
    """Phase 3h's problem: ``n`` points in 2-D (N(0, 1) x [1, 2.5]) with
    uniform weights, as ksize_bandwidths_sharded forms them, and their
    sort bracket."""
    import torch
    from kde_tpu_torch.ops import loocv
    rng = np.random.default_rng(seed + 90 + n)
    dt = getattr(torch, dtype)
    pts = torch.as_tensor(rng.normal(size=(n, 2)) * [1.0, 2.5], dtype=dt,
                          device=dev)
    w = torch.full((n,), 1.0 / n, dtype=dt, device=dev)
    bracket = loocv.bracket_rows(pts.T.contiguous(),
                                 *loocv._slices_on(n, dev))
    return pts, w, bracket


def _k7_sweeps(pts, w, bracket, q=None, q0=0, **kw):
    """A search's sweep buffers on one rank: the queries ``q`` (rows ``q0``
    on; all of ``pts`` by default) against every column, staged anew."""
    from kde_tpu_torch.ops import sharded_loo as sl
    base, ax, bx, cx = bracket
    q = pts if q is None else q
    qw = w[q0:q0 + q.shape[0]]
    xs, wp, st, fl = sl.stage(pts, w, ax, bx, cx)
    return sl.sweeps(q, qw, xs, wp, sl.nn_shift(q, xs, wp, q0), base, st, fl,
                     q0=q0, tol=K4_TOL, **kw)


def k7_phase_calls(pts, w, bracket, twin=False):
    """One call of each K7 launch on one rank (S = 1) with sweep 0's and
    sweep 1's inputs, as closures: name -> fn; with ``twin`` each launch's
    plain twin (``*_ref``) on the same inputs.  Sweep 1 reads buffer 0 and
    ent[0] and writes the other buffer, and the golden step works on
    copies of the state, so repeated calls see the same inputs."""
    import torch
    from kde_tpu_torch.ops import sharded_loo as sl
    base, ax, bx, cx = bracket
    fn = {k: getattr(sl, k + ("_ref" if twin else "")) for k in (
        "stage", "nn_shift", "sweep", "golden_step")}
    sw = _k7_sweeps(pts, w, bracket)
    sl.sweep(sw, 0)
    sl.sweep(sw, 1)
    ent1 = sw.ent_v[1].clone()
    return {
        "stage": lambda: fn["stage"](pts, w, ax, bx, cx),
        "nn_shift": lambda: fn["nn_shift"](pts, sw.xs, sw.wp),
        "sweep_0": lambda: fn["sweep"](sw, 0),
        "sweep_1": lambda: fn["sweep"](sw, 1),
        "golden_step": lambda: fn["golden_step"](
            ent1, base, sw.st.clone(), sw.fl.clone(), torch.empty_like(base),
            sw.flags[:1].clone(), 1, K4_TOL)}


def k7_compare(pts, w, bracket, what, ranks=1):
    """Every K7 launch of sweeps 0, 1 and 2 against its twin on the same
    inputs, over ``ranks`` query shards with every column on each (the
    psum composed by hand): staging, shifts, each sweep's head (state,
    flags, picks, trace) and the closing golden step bitwise; the
    entropies within K7_SUM_RTOL.  The twin's sweeps take the kernels'
    summed entropies, so each head folds the same values.  Returns the
    largest relative errors."""
    import torch
    from kde_tpu_torch.ops import loo_search, sharded_loo as sl
    base, ax, bx, cx = bracket
    rtol = K7_SUM_RTOL[str(pts.dtype).split(".")[-1]]
    err = {}

    def check(name, got, want, exact):
        if exact:
            if not torch.equal(torch.nan_to_num(got, nan=0.5),
                               torch.nan_to_num(want, nan=0.5)):
                raise AssertionError(f"sharded_loo ({what}): {name} differs "
                                     "from its twin")
            err[name] = 0.0
            return
        if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
            raise AssertionError(f"sharded_loo ({what}): {name}'s finite "
                                 "entries differ from its twin's")
        fin = torch.isfinite(want)
        rel = float(((got[fin] - want[fin]).abs()
                     / want[fin].abs().clamp_min(1e-300)).max())
        err[name] = max(err.get(name, 0.0), rel)
        if not rel <= rtol:
            raise AssertionError(f"sharded_loo ({what}): {name} {rel:.3g} "
                                 f"from its twin (rtol {rtol})")
    got = sl.stage(pts, w, ax, bx, cx)
    want = sl.stage_ref(pts, w, ax, bx, cx)
    for name, g, t in (("stage xs", got[0], want[0]),
                       ("stage wp", got[1], want[1]),
                       ("stage st", got[2][0], want[2][0]),
                       ("stage fl", got[3][0], want[3][0])):
        check(name, g, t, True)
    n = pts.shape[0]
    m = -(-n // ranks)
    sides = []
    for r in range(ranks):
        q0 = min(n, r * m)
        q = pts[q0:q0 + m]
        if not len(q):
            continue
        pair = [_k7_sweeps(pts, w, bracket, q=q, q0=q0,
                           trace=loo_search.new_trace(pts.T, K4_TOL))
                for _ in range(2)]
        check("nn_shift", pair[0].shift, sl.nn_shift_ref(
            q, pair[0].xs, pair[0].wp, q0), True)
        sides.append(pair)
    for s in (0, 1, 2):
        for k, t in sides:
            sl.sweep(k, s)
            sl.sweep_ref(t, s)
            check("sweep ent", k.ent_v[s], t.ent_v[s], False)
            b = s & 1
            for name, g, h in (("sweep st", k.st[b], t.st[b]),
                               ("sweep fl", k.fl[b], t.fl[b]),
                               ("sweep flag", k.flag_v[s], t.flag_v[s]),
                               ("sweep trace", k.trace, t.trace)):
                check(name, g, h, True)
            if s:
                check("sweep xmin", k.xmin, t.xmin, True)
        total = sum(k.ent_v[s] for k, _ in sides)
        for pair in sides:
            for side in pair:
                side.ent_v[s].copy_(total)
    k, t = sides[0]
    outs = []
    for side, fn in ((k, sl.golden_step), (t, sl.golden_step_ref)):
        flag = side.flags[:1].clone()
        fn(side.ent_v[2], base, side.st, side.fl, side.xmin, flag, 2,
           K4_TOL, side.trace)
        outs.append((side.st[1], side.fl[1], side.xmin, flag, side.trace))
    for name, g, h in zip(("golden_step st", "golden_step fl",
                           "golden_step xmin", "golden_step flag",
                           "golden_step trace"), *outs):
        check(name, g, h, True)
    return err


def k7_bound_ms(pts, w, probes, sms, clock_hz, fp64_per_pair):
    """The least time an H100 could take for a K7 search of ``pts`` at S =
    1, counted as k4_bound_ms counts K4's: every live pair (i != j, both
    weights positive) once for the shifts and once per probe of its row
    (``probes [d]``, from the trace), on the SFU's ex2 (float32, 16 a clock
    an SM) or the FP64 pipe; the points, weights and brackets read once."""
    return k4_bound_ms((pts.T, w), probes, sms, clock_hz, fp64_per_pair)


def k7_sweep_bound_ms(n_live, rows, dtype, sms, clock_hz, fp64_per_pair):
    """The least time of one sweep's probe work, ``rows`` probe rows over
    ``n_live`` live points (sweep 0: x1 and x2 of both dimensions, 4):
    n_live (n_live - 1) pairs a row, one ex2 each on the SFU or 4 FP32
    instructions (float32), ``fp64_per_pair`` FP64 instructions (float64)."""
    pairs = rows * n_live * (n_live - 1)
    rate = sms * clock_hz
    if dtype == "float32":
        return 1e3 * max(pairs / (SFU_EX2_PER_CLK * rate),
                         4 * pairs / (FP32_LANES_PER_CLK * rate))
    return 1e3 * fp64_per_pair * pairs / (FP64_LANES_PER_CLK * rate)


K7_COMPARE_RANKS = 4     # 3h: the query split k7_compare also holds


def phase_sharded_loo(dev, cases=None):
    """Phase 3h: K7 (sharded_loo, csrc/sharded_loo.cu) against its twins
    on the card at phase 11a's search and the full-width one (K7_CASES),
    float32 and float64, on one NCCL rank (S = 1): each launch of sweeps
    0-2 and the closing step (k7_compare's limits), at 11a's shape also
    over K7_COMPARE_RANKS query shards (the chunked plan); the search
    itself bitwise the same over repeated calls, through
    ksize_bandwidths_sharded, with its trace; at 11a's shape the twin
    search's picks (float64 within K4_F64_RTOL, float32 within
    KSIZE_RTOL).  Each launch timed (one call, the wrapper's host work
    included) beside its twin, and the search beside k7_bound_ms and, at
    11a's shape, the twin search.  No single PyTorch call runs a LOO
    golden search: library_ms is null.
    Returns the rows printed."""
    import torch
    import torch.distributed as dist
    from kde_tpu_torch import parallel as par
    from kde_tpu_torch.ops import loo_search, sharded_loo as sl
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = _sm_clock_hz()
    per_pair = k4_fp64_per_pair(loo_search.build())[0]
    rows = {}
    par.initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                             backend="nccl" if dev.type == "cuda" else "gloo",
                             timeout=WORKER_TIMEOUT)
    try:
        mesh = par.make_mesh_2d((1, 1))
        for name, (n, dtype) in (cases or K7_CASES).items():
            pts, w, bracket = k7_inputs(n, dtype, dev)
            with _uncounted():
                row = dict(n=n, dtype=dtype, plans=[
                    list(sl.sweep_plan(n, sl.n_padded(n), r, sms))
                    for r in (4, 2)],
                    phase_max_rel=k7_compare(pts, w, bracket, name))
                if n == N_KSIZE:
                    row["split_max_rel"] = k7_compare(
                        pts, w, bracket, f"{name} over {K7_COMPARE_RANKS}",
                        ranks=K7_COMPARE_RANKS)
            search = functools.partial(par.ksize_bandwidths_sharded, mesh,
                                       pts)
            with _uncounted():
                got = search()
                again = [search() for _ in range(2)]
                if not all(torch.equal(a, got) for a in again):
                    raise AssertionError(f"sharded_loo ({name}): repeated "
                                         "searches differ")
                trace = loo_search.new_trace(pts.T, K4_TOL)
                base, ax, bx, cx = bracket
                sl.search(pts, w, pts, w, base, ax, bx, cx, tol=K4_TOL,
                          trace=trace)
                row.update(sl.LAST)
                probes = (~torch.isnan(trace[:, :, 0])).sum(dim=1)
                row["probes"] = probes.tolist()
                row["ms"] = _cuda_ms(search)
                calls = k7_phase_calls(pts, w, bracket)
                twins = k7_phase_calls(pts, w, bracket, twin=True)
                row["phase_ms"] = {k: _cuda_ms(fn) for k, fn in calls.items()}
                row["phase_plain_ms"] = {k: _cuda_ms(fn, reps=2)
                                         for k, fn in twins.items()}
                if n == N_KSIZE:
                    def twin_search():
                        with _k7_on_twin():
                            return sl.search(pts, w, pts, w, base, ax, bx,
                                             cx, tol=K4_TOL)
                    want = twin_search()
                    rel = float(((got.double() - want.double()).abs()
                                 / want.double().abs()).max())
                    limit = (K4_F64_RTOL if dtype == "float64"
                             else KSIZE_RTOL)
                    if not rel <= limit:
                        raise AssertionError(f"sharded_loo ({name}): picks "
                                             f"{rel:.3g} from the twin "
                                             f"search's (limit {limit})")
                    row["twin_rel"] = rel
                    row["max_abs_err"] = float((got.double()
                                                - want.double()).abs().max())
                    row["plain_ms"] = _cuda_ms(twin_search, reps=2)
            row["bound_ms"], row["bound_by"] = k7_bound_ms(
                pts, w, row["probes"], sms, clock, per_pair)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["sweep_0_bound_ms"] = k7_sweep_bound_ms(
                n, 4, dtype, sms, clock, per_pair)
            row["library_ms"] = None
            row["bandwidths"] = got.tolist()
            rows[name] = row
            print(f"sharded_loo ({name}): {json.dumps(row)}", flush=True)
            del pts, w, bracket, got
    finally:
        dist.destroy_process_group()
    return rows


def k6_inputs(seed, dev, dtype, c, w, d, js, cov, codes, n_shards, dn=2,
              pad=0, dead=0, mixed=False, uniform=None):
    """One selection of the kernel-sharded engine at one level, its
    ``w`` candidates of ``dn`` densities in ``d`` dims split over
    ``n_shards`` shards as ``_KShardPlan`` splits them (padded to a
    multiple of the shards by repeating the last slot at -inf
    log-weight): ``c`` chains at N(0, I) (angles uniform on circular
    dims), bandwidths at Silverman's scale for ``w`` points, weights
    uniform(0.5, 1.5), labels a permutation; ``cov`` at the same scale or
    None; ``pad`` padded candidates at the end of the last density's
    level (more than w / 2 leave its last half-shard only padding),
    ``dead`` chains at 10^3 on the Euclidean dims, ``mixed``: density
    1's first dim inactive; ``uniform``: "all" gives every candidate of a
    density its first candidate's bandwidth, "half" only those of the
    first shard's slice (at S = 2 a level uniform on shard 0 and not on
    shard 1), "dim0" only in dim 0 (the same draws either way).  Returns a
    dict: ``rows`` (``sharded_select.Rows`` a shard), ``stats`` and
    ``real`` a shard, ``u [c, |js|]``, ``js``, ``n_shards``."""
    import torch
    from kde_tpu_torch.ops import gibbs_select, sharded_select as ss
    rng = np.random.default_rng(seed)
    circ = np.asarray(codes, dtype=bool)
    mean = rng.normal(size=(dn, w, d))
    mean[..., circ] = rng.uniform(-np.pi, np.pi, size=(dn, w, circ.sum()))
    h2 = (1.06 * max(w, 2) ** -0.2) ** 2
    bw = h2 * rng.uniform(0.5, 1.5, size=(dn, w, d))
    w_loc = -(-w // n_shards)
    if uniform == "all":
        bw[:] = bw[:, :1]
    elif uniform == "half":
        bw[:, :w_loc] = bw[:, :1]
    elif uniform == "dim0":
        bw[..., 0] = bw[:, :1, 0]
    wt = rng.uniform(0.5, 1.5, size=(dn, w))
    logw = np.log(wt / wt.sum(axis=-1, keepdims=True))
    if pad:
        logw[-1, -pad:] = -np.inf
    perm = np.argsort(rng.random((dn, w)), axis=-1).astype(np.float64)
    mu = rng.normal(size=(c, d))
    mu[:, circ] = rng.uniform(-np.pi, np.pi, size=(c, circ.sum()))
    if dead:
        mu[:dead, ~circ] = 1e3
    active = np.ones((dn, d), dtype=bool)
    if mixed:
        active[1, 0] = False

    def split(x, fill=None):
        tail = np.repeat(x[:, -1:], n_shards * w_loc - w, axis=1)
        if fill is not None:
            tail[:] = fill
        return np.concatenate([x, tail], axis=1)
    stats = split(np.concatenate([mean, bw, perm[..., None]], axis=-1))
    mean, bw, logw = split(mean), split(bw), split(logw, -np.inf)
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
    covv = t(h2 * rng.uniform(0.5, 1.5, size=(c, d))) if cov else None
    diffop = gibbs_select.diffop_of(codes)
    act = torch.as_tensor(active, device=dev)
    sl = lambda s: slice(s * w_loc, (s + 1) * w_loc)
    js = tuple(js)
    return dict(
        rows=[ss.Rows(t(mean[:, sl(s)]).contiguous(),
                      t(bw[:, sl(s)]).contiguous(),
                      t(logw[:, sl(s)]).contiguous(), js, t(mu), covv, act,
                      diffop) for s in range(n_shards)],
        stats=[torch.as_tensor(stats[:, sl(s)], dtype=torch.float64,
                               device=dev).contiguous()
               for s in range(n_shards)],
        real=[torch.as_tensor(np.isfinite(logw[js[0]:js[-1] + 1, sl(s)])
                              .any(axis=-1), device=dev)
              for s in range(n_shards)],
        u=t(rng.uniform(size=(c, len(js)))), js=js, n_shards=n_shards)


K6_PHASES = ("local_max", "shifted_sum", "dead_max", "exp_sum",
             "count_below", "owner_stats")
K6_TIE = 1e-12           # K6's labels may differ from the twin's only where
                         # the twin's float64 CDF is this near u
K6_MAX_TIES = 100        # ...on at most this many rows of a case


def k6_select(inp, twin=False, ss=None):
    """One kernel-sharded selection over ``inp``'s shards on one rank, the
    collectives by hand in the engine's order (max, sum and stack over
    the shards): K6's entries on a stage prepared a shard
    (``sharded_select.prepare``), or with ``twin`` their plain twins on the
    rows.  Returns every phase's outputs (per shard where each shard has
    its own), the winner's stats ``sel [|js|, C, 2d+1]`` and the
    ``stages``.  ``ss``: another checkout's sharded_select module."""
    import torch
    if ss is None:
        from kde_tpu_torch.ops import sharded_select as ss
    f = {n: getattr(ss, n + "_ref" if twin else n) for n in K6_PHASES}
    js, S = inp["js"], inp["n_shards"]
    rows = inp["rows"] if twin else [ss.prepare(r) for r in inp["rows"]]
    m = [f["local_max"](r) for r in rows]
    m0 = torch.stack(m).amax(dim=0)
    ssum_s = [f["shifted_sum"](r, m0) for r in rows]
    ssum = torch.stack(ssum_s).sum(dim=0)
    dm = [f["dead_max"](m0, ssum, m[s], inp["real"][s]) for s in range(S)]
    dead = dm[0][0]
    gmax = torch.stack([x[1] for x in dm]).amax(dim=0)
    tots = torch.stack([f["exp_sum"](r, gmax, dead) for r in rows])
    counts = [f["count_below"](r, gmax, dead, tots, s, inp["u"])
              for s, r in enumerate(rows)]
    z = torch.stack(counts).sum(dim=0)
    sel = torch.stack([f["owner_stats"](inp["stats"][s], js, z, S, s)
                       for s in range(S)]).sum(dim=0)
    return dict(m=m, m0=m0, ssum=ssum_s, dead=dead, mfb=[x[1] for x in dm],
                gmax=gmax, tots=tots, counts=counts, z=z, sel=sel,
                stages=rows)


def _k6_twin_cdf(inp, got, jj, c):
    """The twin's float64 CDF of row ``(js[jj], c)`` over all shards
    (its offsets and total), from the twin's own phase outputs ``got``."""
    import torch
    from kde_tpu_torch.ops import sharded_select as ss
    parts = []
    tots = got["tots"][:, jj, c]
    total = tots.sum()
    for s, r in enumerate(inp["rows"]):
        one = r._replace(mu=r.mu[c:c + 1], js=(r.js[jj],),
                         cov=None if r.cov is None else r.cov[c:c + 1])
        e = torch.exp(ss._fallback_logits(one, got["dead"][jj:jj + 1,
                                                           c:c + 1])
                      - got["gmax"][jj, c]).double()[0, 0]
        parts.append((tots[:s].sum() + torch.cumsum(e, dim=0)) / total)
    return torch.cat(parts)


def k6_compare(inp, what):
    """K6 against its twins on the same inputs, phase by phase: the local
    and global maxima, the fallback maxima and the dead rows equal; the
    shifted sums within 2e-5 (float32) or 1e-12 (float64) relative (sums
    in another order), the shard totals within 1e-12 relative; the global
    index on every row but those where the twin's float64 CDF lies within
    K6_TIE of u between the two indices (listed with |u - cdf|); the
    winner's stats equal wherever the indices are.  Returns the row of
    findings."""
    import torch
    from kde_tpu_torch.ops import sharded_select as ss
    before = ss.LAUNCHES
    got = k6_select(inp)
    _sync()
    launched = ss.LAUNCHES - before
    on_card = inp["rows"][0].mean.is_cuda
    if launched != (6 * inp["n_shards"] if on_card else 0):
        raise AssertionError(f"sharded_select ({what}): {launched} launches "
                             f"for {inp['n_shards']} shards")
    want = k6_select(inp, twin=True)
    rel = lambda a, b: float(((a.double() - b.double()).abs()
                              / b.double().abs().clamp_min(1e-300)).max())
    for k in ("m0", "dead", "gmax"):
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"sharded_select ({what}): {k} differs from "
                                 "the twin's")
    for k in ("m", "mfb"):
        if not all(torch.equal(a, b) for a, b in zip(got[k], want[k])):
            raise AssertionError(f"sharded_select ({what}): {k} differs from "
                                 "the twin's")
    f32 = inp["rows"][0].mean.dtype == torch.float32
    ssum_rel = max(rel(a, b) for a, b in zip(got["ssum"], want["ssum"]))
    tots_rel = rel(got["tots"], want["tots"])
    if ssum_rel > (2e-5 if f32 else 1e-12) or tots_rel > 1e-12:
        raise AssertionError(f"sharded_select ({what}): shifted sums "
                             f"{ssum_rel}, shard totals {tots_rel} apart")
    same = got["z"] == want["z"]
    bad = (~same).nonzero().tolist()
    if len(bad) > K6_MAX_TIES:
        raise AssertionError(f"sharded_select ({what}): {len(bad)} indices "
                             "off the twin's")
    ties = []
    for jj, c in bad:
        cdf = _k6_twin_cdf(inp, want, jj, c)
        zk, zt = int(got["z"][jj, c]), int(want["z"][jj, c])
        lo, hi = min(zk, zt), min(max(zk, zt), cdf.numel())
        gap = float((cdf[lo:hi] - float(inp["u"][c, jj])).abs().max())
        if gap > K6_TIE:
            raise AssertionError(f"sharded_select ({what}): row {jj, c} "
                                 f"takes {zk}, the twin {zt}, |u - cdf| "
                                 f"{gap}")
        ties.append(gap)
    keep = same[..., None].expand_as(got["sel"])
    err = float((got["sel"] - want["sel"])[keep].abs().max()) \
        if bool(keep.any()) else 0.0
    if err != 0.0:
        raise AssertionError(f"sharded_select ({what}): winner stats {err} "
                             "off the twin's at equal indices")
    return dict(rows=same.numel(), dead_rows=int(got["dead"].sum()),
                launches=launched, index_mismatches=len(bad), cdf_ties=ties,
                ssum_max_rel=ssum_rel, tots_max_rel=tots_rel,
                max_abs_err=err)


def k6_bound_ms(inp, sms, clock_hz):
    """The least time an H100 could take for the local work of one
    kernel-sharded selection over all its shards (collectives excluded),
    counting cdf's work per (chain, candidate) pair as chain_bound_ms
    does: k IEEE divisions (a reciprocal each on the SFU), k logs or,
    where the level's bandwidth is uniform in a dim, one log a row, an exp
    and 5k + 5 FP32 operations, k the active dims; the dead test's sum on
    rows below log(1e-99) left out.  SFU at 16 a clock an SM, FP32 on 128
    lanes an SM; bytes (the densities' level slices and stats, mu, cov and
    u read once, the winners' stats written once) at 3.35 TB/s."""
    rows = inp["rows"]
    r0 = rows[0]
    js = list(inp["js"])
    c, d = r0.mu.shape
    item = r0.mean.element_size()
    w = sum(r.mean.shape[1] for r in rows)
    act = r0.active[js].cpu().numpy()
    bw = np.concatenate([r.bw[js].cpu().numpy() for r in rows], axis=1)
    uni = (bw == bw[:, :1]).all(axis=1)                      # [|js|, d]
    k = act.sum(axis=-1).astype(float)
    ku = (act & uni).sum(axis=-1).astype(float)
    sfu = float((c * w * (2 * k + 1 - ku) + c * ku).sum())
    fp32 = float((c * w * (5 * k + 5)).sum())
    nbytes = (len(js) * w * ((2 * d + 1) * item + (2 * d + 1) * 8)
              + c * d * item * (2 if r0.cov is not None else 1)
              + c * len(js) * (item + (2 * d + 1) * 8))
    times = {"operations": max(sfu / (SFU_EX2_PER_CLK * sms * clock_hz),
                               fp32 / (FP32_LANES_PER_CLK * sms * clock_hz)),
             "bytes": nbytes / HBM_BYTES}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def k6_phase_calls(inp, twin=False, ss=None):
    """Each phase of one shard-0 selection as a call on fixed inputs (the
    earlier phases' outputs, from K6), for timing: name -> callable.  K6's
    calls start with ``prepare`` (once a stage) and take its stage; the
    twins take the rows.  ``ss``: another checkout's sharded_select module
    (one without ``prepare`` takes the rows)."""
    import functools as ft
    if ss is None:
        from kde_tpu_torch.ops import sharded_select as ss
    pre = k6_select(inp)
    f = {n: getattr(ss, n + "_ref" if twin else n) for n in K6_PHASES}
    r, s = inp["rows"][0], 0
    calls = {}
    if not twin and hasattr(ss, "prepare"):
        calls["prepare"] = ft.partial(ss.prepare, r)
        r = ss.prepare(r)
        f["exp_sum"](r, pre["gmax"], pre["dead"])     # count_below reads it
    return {**calls, "local_max": ft.partial(f["local_max"], r),
            "shifted_sum": ft.partial(f["shifted_sum"], r, pre["m0"]),
            "dead_max": ft.partial(f["dead_max"], pre["m0"],
                                   sum(pre["ssum"]), pre["m"][s],
                                   inp["real"][s]),
            "exp_sum": ft.partial(f["exp_sum"], r, pre["gmax"], pre["dead"]),
            "count_below": ft.partial(f["count_below"], r, pre["gmax"],
                                      pre["dead"], pre["tots"], s, inp["u"]),
            "owner_stats": ft.partial(f["owner_stats"], inp["stats"][s],
                                      inp["js"], pre["z"], inp["n_shards"],
                                      s)}


def k6_raw_calls(inp):
    """The bare kernel calls of the same phases as k6_phase_calls (K6's),
    without the wrappers' checks, allocations and packing: the row phases
    through ``Stage.launch`` into outputs made beforehand, dead_max and
    owner_stats through their ctypes entries with every argument
    precomputed.  name -> callable."""
    import torch
    from kde_tpu_torch.ops import sharded_select as ss
    pre = k6_select(inp)
    st = ss.prepare(inp["rows"][0])
    g, dd = pre["gmax"], pre["dead"]
    ss.exp_sum(st, g, dd)
    lib = ss._load()
    dev = st.device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    outs = {n: st.out(t) for n, t in (("m", st.dtype), ("s", st.dtype),
                                      ("e", torch.float64),
                                      ("z", torch.int64))}
    m0, m, real = pre["m0"], pre["m"][0], inp["real"][0]
    ssum = sum(pre["ssum"])
    dead, mfb = torch.empty_like(dd), torch.empty_like(m)
    dm = (m.element_size(), m0.data_ptr(), ssum.data_ptr(), m.data_ptr(),
          real.data_ptr(), m.shape[0], m.shape[1], ss.LOG_DEAD,
          dead.data_ptr(), mfb.data_ptr(), stream)
    stats, js, z, S = inp["stats"][0], inp["js"], pre["z"], inp["n_shards"]
    sel = torch.empty(tuple(z.shape) + (stats.shape[2],),
                      dtype=torch.float64, device=dev)
    os_ = (z.data_ptr(), stats.data_ptr(), stats.stride(0), js[0], len(js),
           z.shape[1], stats.shape[0], stats.shape[1], stats.shape[2], S, 0,
           sel.data_ptr(), stream)
    return {"local_max": lambda: st.launch(0, outs["m"]),
            "shifted_sum": lambda: st.launch(1, outs["s"], m0=m0),
            "dead_max": lambda: lib.kde_k6_dead_max(*dm),
            "exp_sum": lambda: st.launch(2, outs["e"], gmax=g, dead=dd),
            "count_below": lambda: st.launch(
                3, outs["z"], gmax=g, dead=dd, tots=pre["tots"], sid=0,
                u=inp["u"]),
            "owner_stats": lambda: lib.kde_k6_owner_stats(*os_)}


def k6_plan(inp):
    """``sharded_select.plan`` of shard 0's rows on this card, as a dict
    with its block count."""
    import torch
    from kde_tpu_torch.ops import sharded_select as ss
    r = inp["rows"][0]
    dn, w, d = r.mean.shape
    sms = torch.cuda.get_device_properties(r.mean.device).multi_processor_count
    p = ss.plan(r.mu.shape[0], len(inp["js"]), w, d, r.mean.element_size(),
                sms)
    return dict(p._asdict(), blocks=p.blocks)


def k6_chunk_widths(c, n_js, d, itemsize, sms):
    """Widths at the chunk boundaries of ``sharded_select.plan`` for ``c``
    chains over ``n_js`` densities: one chunk of one ring slot less a
    candidate, one exact, and two chunks with a last of one candidate; and
    the plan's full chunk count n of one slot each (n slots less one, n
    exact, n - 1 slots and one).  Each width's plan is checked to cut
    there.  Returns name -> w (the names do not depend on the card)."""
    from kde_tpu_torch.ops import sharded_select as ss
    pl = ss.plan(c, n_js, 1 << 24, d, itemsize, sms)
    slot = pl.slot
    n = pl.chunks
    widths = {"chunk-1": slot - 1, "chunk": slot, "chunk+1": slot + 1,
              "n chunks-1": n * slot - 1, "n chunks": n * slot,
              "n chunks, last 1": (n - 1) * slot + 1}
    want = {"chunk-1": (1, slot - 1), "chunk": (1, slot),
            "chunk+1": (2, 1), "n chunks-1": (n, slot - 1),
            "n chunks": (n, slot), "n chunks, last 1": (n, 1)}
    for name, w in widths.items():
        p = ss.plan(c, n_js, w, d, itemsize, sms)
        got = (p.chunks, w - (p.chunks - 1) * p.chunk)
        if p.chunk != slot or got != want[name]:
            raise AssertionError(f"k6_chunk_widths ({name}): w = {w} plans "
                                 f"{p}, want (chunks, last) {want[name]}")
    return widths


# phase 3g: name -> (chains, w, d, js, dtype, cov, codes, shards, extras);
# the timed cases are S = 1 slices at phase 11a's leaf (256 chains over
# 2 x 50,000) and at the full-width case's (2 x 1,000,000), with the
# bandwidths of k6_inputs (varied) and, as a fitted density's leaves have
# them, uniform
K6_TIMED = ("leaf cond", "leaf sweep", "1M leaf sweep", "leaf sweep uniform",
            "1M leaf sweep uniform")


def k6_cases(n_leaf=N_SERVE, n_big=1_000_000, chains=SERVE_CHAINS, sms=132):
    import torch
    f32, f64 = torch.float32, torch.float64
    cases = {
        "leaf cond": (chains, n_leaf, 2, (0, 1), f32, False, (0, 0), 1, {}),
        "leaf sweep": (chains, n_leaf, 2, (1,), f32, True, (0, 0), 1, {}),
        "1M leaf sweep": (chains, n_big, 2, (0,), f32, True, (0, 0), 1, {}),
        "leaf cond S=2": (chains, n_leaf, 2, (0, 1), f32, False, (0, 0), 2,
                          {}),
        "f64 replay S=2": (chains, 2000, 2, (0, 1), f64, False, (0, 0), 2,
                           {}),
        "f64 sweep S=1": (chains, 2000, 2, (1,), f64, True, (0, 0), 1, {}),
        "circular S=2": (512, 4000, 1, (0, 1), f32, False, (1,), 2, {}),
        "se2 S=2": (512, 4000, 3, (1,), f32, True, (0, 0, 1), 2, {}),
        "se2 f64 S=1": (128, 1000, 3, (0, 1), f64, False, (0, 0, 1), 1, {}),
        "dead pad S=2": (512, 1000, 2, (0, 1), f32, False, (0, 0), 2,
                         dict(pad=700, dead=5, mixed=True)),
        "dead pad f64 S=2": (512, 1000, 2, (1,), f64, True, (0, 0), 2,
                             dict(pad=700, dead=5)),
        "mixed S=1": (256, 3000, 2, (1,), f32, True, (0, 0), 1,
                      dict(mixed=True)),
        "dn=3 cond S=2": (256, 2000, 2, (0, 1, 2), f32, False, (0, 0), 2,
                          dict(dn=3)),
        "dn=3 sweep S=1": (256, 2000, 2, (2,), f64, True, (0, 0), 1,
                           dict(dn=3)),
    }
    for d in (1, 2, 3):
        for dt in (f32, f64):
            cases[f"d={d} {str(dt)[-7:]} S=2"] = (
                128, 300, d, (0, 1), dt, d % 2 == 0, (0,) * d, 2, {})
    for w, S in ((1024, 1), (1025, 1), (2049, 2)):   # the warp/block switch
        cases[f"w={w} S={S}"] = (64, w, 2, (0,), f32, True, (0, 0), S, {})
    uni = dict(uniform="all")
    cases.update({
        "leaf sweep uniform": (chains, n_leaf, 2, (1,), f32, True, (0, 0), 1,
                               uni),
        "1M leaf sweep uniform": (chains, n_big, 2, (0,), f32, True, (0, 0),
                                  1, uni),
        "leaf cond uniform S=2": (chains, n_leaf, 2, (0, 1), f32, False,
                                  (0, 0), 2, uni),
        "half uniform S=2": (512, 4000, 2, (0, 1), f32, True, (0, 0), 2,
                             dict(uniform="half")),
        "dim0 uniform f64 S=2": (256, 3000, 2, (1,), f64, False, (0, 0), 2,
                                 dict(uniform="dim0", dead=5)),
        "se2 uniform S=1": (512, 4000, 3, (0, 1), f32, True, (0, 0, 1), 1,
                            uni),
        "dead pad uniform S=2": (512, 1000, 2, (0, 1), f32, True, (0, 0), 2,
                                 dict(pad=700, dead=5, uniform="all")),
        "d=5 uniform f64 S=2": (128, 700, 5, (0, 1), f64, True, (0,) * 5, 2,
                                dict(uniform="dim0")),
        "w=1 S=1": (chains, 1, 2, (0, 1), f32, True, (0, 0), 1, {}),
    })
    # the chunk boundaries of the plan, float32 and float64, S = 1
    for dt, item in ((f32, 4), (f64, 8)):
        for name, w in k6_chunk_widths(chains, 1, 2, item, sms).items():
            cases[f"w={w} ({name}) {str(dt)[-7:]}"] = (
                chains, w, 2, (1,), dt, True, (0, 0), 1,
                dict(uniform="all") if item == 8 else {})
    return cases


def phase_sharded_select(dev, cases=None):
    """Phase 3g: K6 (sharded_select, csrc/sharded_select.cu) against its
    plain twins on the card, the shards composed on one rank (S = 1
    slices, S = 2 halves): k6_compare's limits at every case; each phase
    of the timed cases (K6_TIMED) timed (one call, the wrapper's host
    work included) beside its twin, and their sum, one selection's local
    work, beside k6_bound_ms.  No single PyTorch call computes a sharded
    selection: library_ms is null.  Returns the rows printed."""
    import torch
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = _sm_clock_hz()
    rows = {}
    for i, (name, (c, w, d, js, dt, cov, codes, S, ex)) in \
            enumerate((cases or k6_cases(sms=sms)).items()):
        inp = k6_inputs(SEED + 60 + i, dev, dt, c, w, d, js, cov, codes, S,
                        **ex)
        with _uncounted():
            row = k6_compare(inp, name)
        row.update(C=c, w=w, d=d, js=list(js), dtype=str(dt), shards=S,
                   codes=list(codes))
        if name in K6_TIMED:
            with _uncounted():
                calls = k6_phase_calls(inp)
                twins = k6_phase_calls(inp, twin=True)
                row["phase_ms"] = {n: _cuda_ms(fn) for n, fn in calls.items()}
                row["phase_raw_ms"] = {n: _cuda_ms(fn) for n, fn in
                                       k6_raw_calls(inp).items()}
                row["phase_plain_ms"] = {n: _cuda_ms(fn, reps=2)
                                         for n, fn in twins.items()}
            row["plan"] = k6_plan(inp)
            row["ms"] = sum(row["phase_ms"].values())
            row["raw_ms"] = sum(row["phase_raw_ms"].values())
            row["plain_ms"] = sum(row["phase_plain_ms"].values())
            row["bound_ms"], row["bound_by"] = k6_bound_ms(inp, sms, clock)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["library_ms"] = None
        rows[name] = row
        print(f"sharded_select ({name}): {json.dumps(row)}", flush=True)
        del inp
    return rows


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
    """``fn`` wrapped to add its seconds to ``stages[name]``, its K1
    launches to ``launches[name]`` and its K4 launches to
    ``launches[name + "_k4"]``."""
    from kde_tpu_torch.ops import loo_search, tiled_eval

    def wrapper(*args, **kw):
        sync()
        t0, l0, k0 = (time.perf_counter(), tiled_eval.LAUNCHES,
                      loo_search.LAUNCHES)
        out = fn(*args, **kw)
        sync()
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
        launches[name] = launches.get(name, 0) + tiled_eval.LAUNCHES - l0
        launches[name + "_k4"] = (launches.get(name + "_k4", 0)
                                  + loo_search.LAUNCHES - k0)
        return out
    return wrapper


def _timed_product(run, sync, stages, launches, prefix="", where=None):
    """``run()`` a `*` product, which draws the Gibbs chains and then refits
    the samples with ``kde`` of module ``where`` (default ``ops.gibbs``):
    that call is wrapped to split the two stages' times and launches."""
    from kde_tpu_torch.ops import gibbs, loo_search, tiled_eval
    where = where or gibbs
    refit = where.kde
    where.kde = _timed(prefix + "refit", refit, sync, stages, launches)
    try:
        sync()
        t0, l0, k0 = (time.perf_counter(), tiled_eval.LAUNCHES,
                      loo_search.LAUNCHES)
        out = run()
    finally:
        where.kde = refit
    stages[prefix + "gibbs"] = (time.perf_counter() - t0
                                - stages[prefix + "refit"])
    launches[prefix + "gibbs"] = (tiled_eval.LAUNCHES - l0
                                  - launches[prefix + "refit"])
    launches[prefix + "gibbs_k4"] = (loo_search.LAUNCHES - k0
                                     - launches[prefix + "refit_k4"])
    return out


@contextlib.contextmanager
def _on_stage_route():
    """Every product that would take the chain kernel (ops/gibbs.py::
    _route gives "chain") on the stage route instead: one gibbs_select
    launch a selection step, the eager Gaussian products and point draws
    between them (the parent's route).  cdf keeps no [chains, width]
    temporary on either route, so the chain blocks and keyed draws are the
    same.  The run is a reference: its launches are not the path's."""
    from kde_tpu_torch.ops import gibbs
    saved = gibbs._route
    gibbs._route = lambda *a: ("kernel" if saved(*a) == "chain"
                               else saved(*a))
    try:
        with _uncounted():
            yield
    finally:
        gibbs._route = saved


@contextlib.contextmanager
def _on_gibbs_twin():
    """The stage route with every Gibbs selection on the gibbs_select
    kernel's plain twin (ops/gibbs.py launches it through this one name):
    the whole chain in eager torch ops, the same chain blocks, so keyed
    draws are the same.  The run is a reference: its K1 launches (the
    refits) are not the path's."""
    from kde_tpu_torch.ops import gibbs_select
    saved = gibbs_select.gibbs_select
    gibbs_select.gibbs_select = gibbs_select.gibbs_select_ref
    try:
        with _on_stage_route():
            yield
    finally:
        gibbs_select.gibbs_select = saved


def _same_share(a, b):
    """Share of the rows of ``[..., n, d]`` sample points equal in every
    coordinate."""
    return float((a == b).all(dim=-1).double().mean())


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

    p, q = _timed("fit", lambda: (kt.kde(a), kt.kde(b)), sync, stages,
                  launches)()

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
    # the same product on the stage route (a gibbs_select launch a step)
    # and with every selection on that kernel's plain twin (same seed,
    # same chain blocks): its Gibbs stage is the A/B
    kt.set_seed(seed)
    with _on_stage_route():
        stage = _timed_product(lambda: p * q, sync, stages, launches,
                               "stage_")
    kt.set_seed(seed)
    with _on_gibbs_twin():
        twin = _timed_product(lambda: p * q, sync, stages, launches, "twin_")
    same_points = _same_share(pq.points, twin.points)
    stage_same = _same_share(pq.points, stage.points)

    sync()
    t0, l0 = time.perf_counter(), tiled_eval.LAUNCHES
    lp = pq.log_eval(queries)
    sync()
    stages["evaluate"], launches["evaluate"] = (time.perf_counter() - t0,
                                                tiled_eval.LAUNCHES - l0)

    # checks, by the repo's own means: the fits and the refit are K4
    # launches, the evaluation a K1 launch
    _launched(launches, ("fit", "refit"), dev, k4=True)
    _launched(launches, ("evaluate",), dev)
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
                eval_err_vs_f64=err, twin_same_points=same_points,
                stage_same_points=stage_same), (p, q)


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

    def serve_calls():
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        sync()
        t0 = time.perf_counter()
        outs = [sampler.sample(gen)[0] for _ in range(SERVE_CALLS)]
        sync()
        return outs, time.perf_counter() - t0
    outs, dt = serve_calls()
    with _on_stage_route():              # the A/B: the same calls, stage
        stage, stage_dt = serve_calls()
    with _on_gibbs_twin():               # and twin routes
        twin, twin_dt = serve_calls()
    for o in [pts] + outs:
        if o.shape != (2, SERVE_CHAINS) or not bool(torch.isfinite(o).all()):
            raise AssertionError("serving: wrong shape or non-finite sample")
    same = _same_share(torch.cat(outs, 1).T, torch.cat(twin, 1).T)
    return dict(first_call_s=first, calls=SERVE_CALLS, seconds=dt,
                samples_per_s=SERVE_CALLS * SERVE_CHAINS / dt,
                stage_seconds=stage_dt,
                stage_samples_per_s=SERVE_CALLS * SERVE_CHAINS / stage_dt,
                stage_same_points=_same_share(torch.cat(outs, 1).T,
                                              torch.cat(stage, 1).T),
                twin_seconds=twin_dt,
                twin_samples_per_s=SERVE_CALLS * SERVE_CHAINS / twin_dt,
                twin_same_points=same), sampler


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
    same = {}
    for route, ctx in (("stage", _on_stage_route), ("twin", _on_gibbs_twin)):
        kt.set_seed(seed)
        with ctx():
            ref = _timed_product(lambda: p2 * q2, sync, stages, launches,
                                 route + "_")
        same[route + "_same_points"] = _same_share(pq.points, ref.points)
    build("chained_plan", [pq, q2])
    pqq = _timed_product(lambda: pq * q2, sync, stages, launches, "chained_")
    if any(k._tree is not None for k in (p2, q2, pq)):
        raise AssertionError("the device-plan path built a host tree")
    _launched(launches, ("refit", "chained_refit"), dev, k4=True)
    # N(0, I) x N(0.5, I) = N(0.25, I/2); N(0.25, I/2) x N(0.5, I) has mean
    # (2 * 0.25 + 0.5) / 3 = 1/3
    return dict(seconds=stages, launches=launches, **same,
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

    def batched(prefix=""):
        saved = gibbs.batched_device_plans, gibbs.ksize_rows
        gibbs.batched_device_plans = _timed(prefix + "plan", saved[0], sync,
                                            stages, launches)
        gibbs.ksize_rows = _timed(prefix + "refit", saved[1], sync, stages,
                                  launches)
        try:
            sync()
            t0 = time.perf_counter()
            outs = kt.product_batched(sets, key=seed)
            sync()
            total = time.perf_counter() - t0
        finally:
            gibbs.batched_device_plans, gibbs.ksize_rows = saved
        stages[prefix + "gibbs"] = (total - stages[prefix + "plan"]
                                    - stages[prefix + "refit"])
        return outs
    outs = batched()
    with _on_stage_route():              # the A/B: the same call, stage
        stage = batched("stage_")
    with _on_gibbs_twin():               # and twin routes
        twin = batched("twin_")
    twin_same = [_same_share(k.points, t.points) for k, t in zip(outs, twin)]
    stage_same = [_same_share(k.points, t.points)
                  for k, t in zip(outs, stage)]
    _launched(launches, ("refit",), dev, k4=True)
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
                set0_max_abs_dx=diff, twin_same_points=twin_same,
                stage_same_points=stage_same)


def phase_select(dev, serve, slice_dens, n_comp=1000, n_out=1000,
                 seed=SEED):
    """Phase 8: samples/s of each selection mode at the bench headline
    (B = 6 sets of [2 x n_comp], bw 0.1, n_out chains, Niter 5), at B = 8,
    on phase 5's sampler, and on the Gibbs stage of phase 4's `*` (its two
    densities, as many chains as components); the median of SELECT_REPS
    calls after a warm-up, the modes taken in turns.  Each mode's
    gibbs_chain and gibbs_select launches a call: cdf and gumbel must be
    one gibbs_chain launch and no gibbs_select launch (on the card)."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import gibbs, gibbs_chain, gibbs_select
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
        launches = {}
        for mode in SELECT_MODES:
            k3, k2 = gibbs_chain.LAUNCHES, gibbs_select.LAUNCHES
            sampler.sample(seed, select=mode)
            launches[mode] = dict(gibbs_chain=gibbs_chain.LAUNCHES - k3,
                                  gibbs_select=gibbs_select.LAUNCHES - k2)
            if (dev.type == "cuda" and mode in ("cdf", "gumbel")
                    and launches[mode] != dict(gibbs_chain=1,
                                               gibbs_select=0)):
                raise AssertionError(f"{cell} {mode}: launches "
                                     f"{launches[mode]}, not one gibbs_chain")
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
                          sets=b, launches_per_call=launches,
                          winner=max(rate, key=rate.get),
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


def _launched(launches, names, dev, k4=False):
    """Each stage of ``names`` launched K1 (with ``k4``: K4) on the card."""
    for name in names:
        if launches[name + ("_k4" if k4 else "")] < 1 and dev.type == "cuda":
            raise AssertionError(f"stage {name} never launched "
                                 f"{'K4' if k4 else 'K1'}")


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
    _launched(launches, ("entropy", "eval_avg_logl", "kld", "minkld"), dev)
    _launched(launches, ("kld_unscented", "resample_lcv", "ksize"), dev,
              k4=True)
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


def _circ_pair(rng, n, dev, shift=0.0):
    """The pair of tests/test_manifolds.py:67-70, either side of pi, ``n``
    angles each drawn from ``rng``, as circular float32 densities on
    ``dev``."""
    import torch
    import kde_tpu_torch as kt
    a = _wrap(np.pi - 0.2 + shift + 0.05 * rng.normal(size=(1, n)))
    b = _wrap(-np.pi + 0.2 + shift + 0.05 * rng.normal(size=(1, n)))
    return [kt.kde(torch.as_tensor(x, dtype=torch.float32, device=dev),
                   [0.1], **_hook_kw("c")) for x in (a, b)]


def _many_densities(dev, n=N_MANY, dn=MANY_DENS, seed=SEED):
    """Phase 10b's ``dn`` float32 densities of ``n`` 2-D points each
    (N(0.1 i, 1) at Silverman's bandwidth for ``n``), on ``dev``."""
    import torch
    import kde_tpu_torch as kt
    rng = np.random.default_rng(seed + 30)
    bw = [float(1.06 * n ** -0.2)]
    return [kt.kde((rng.normal(size=(2, n)) + 0.1 * i).astype(np.float32),
                   bw, device=dev, dtype=torch.float32) for i in range(dn)]


def phase_many_densities(dev, n=N_MANY, dn=MANY_DENS, n_out=MANY_CHAINS,
                         seed=SEED):
    """Phase 10b: a keyed cdf product of ``dn`` densities of ``n`` 2-D
    points, more than the chain kernel takes (gibbs_chain.MAX_DENS), so
    the stage route: one gibbs_select launch a selection step, the tiles
    at its wide levels.  Its Gibbs seconds and K2 launches; then the same
    call with every selection on K2's twin (``_on_gibbs_twin``), and the
    share of chains whose labels agree (at least AGREE_MIN: cdf labels
    part only at float64 CDF ties)."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import gibbs, gibbs_select
    card = dev.type == "cuda"
    sync = _sync if card else (lambda: None)
    dens = _many_densities(dev, n, dn, seed)
    route = gibbs._route("cdf", None, dev, dn, 2)
    if card and route != "kernel":
        raise AssertionError(f"{dn} densities take the {route} route")
    call = functools.partial(kt.prod_appx_ms_gibbs, n_out, dens, key=seed,
                             select="cdf")
    call()                                       # the plan, the build
    sync()
    k2 = gibbs_select.LAUNCHES
    t0 = time.perf_counter()
    got = call()
    sync()
    out = dict(n=n, densities=dn, chains=n_out, route=route,
               gibbs_s=time.perf_counter() - t0,
               gibbs_select_launches=gibbs_select.LAUNCHES - k2)
    with _on_gibbs_twin():
        t0 = time.perf_counter()
        twin = call()
        sync()
        out["twin_gibbs_s"] = time.perf_counter() - t0
    out["twin_same_labels"] = float((got[1] == twin[1]).all(dim=0)
                                    .double().mean())
    out["finite"] = bool(torch.isfinite(got[0]).all())
    if card and (out["gibbs_select_launches"] < 1 or not out["finite"]
                 or out["twin_same_labels"] < AGREE_MIN):
        raise AssertionError(f"{dn}-density product: {out}")
    return out


def phase_manifolds(dev, n=N_SLICE, b=BATCH_SETS, seed=SEED):
    """Phase 10: circular and SE(2) products at full width, a hooked
    batched product, and the circular pair multiplied with a lone circular
    diffop (explicit hooks: no circular quadruple, so the stage route, a
    gibbs_select launch a selection step) with cdf and gumbel, each
    against the same call on gibbs_select's twin."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch import manifolds
    from kde_tpu_torch.ops import gibbs, gibbs_select, kernels
    from kde_tpu_torch.utils.random import split
    rng = np.random.default_rng(seed + 5)
    sync = _sync if dev.type == "cuda" else (lambda: None)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    circ, se2 = _hook_kw("c"), _hook_kw("eec")
    stages, launches, out = {}, {}, {}
    circ_pair = functools.partial(_circ_pair, rng, n, dev)

    pa, pb = circ_pair()
    kt.set_seed(seed)
    pq = _timed_product(lambda: pa * pb, sync, stages, launches)
    kt.set_seed(seed)
    with _on_stage_route():              # the A/B: the same product, stage
        ref = _timed_product(lambda: pa * pb, sync, stages, launches,
                             "stage_")
    out["stage_same_points"] = _same_share(pq.points, ref.points)
    kt.set_seed(seed)
    with _on_gibbs_twin():               # and twin routes
        twin = _timed_product(lambda: pa * pb, sync, stages, launches,
                              "twin_")
    out["twin_same_points"] = _same_share(pq.points, twin.points)
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
    kt.set_seed(seed)
    fused = _timed_product(lambda: sa * sb, sync, stages, launches, "se2_")
    kt.set_seed(seed)
    with _on_stage_route():
        ref = _timed_product(lambda: sa * sb, sync, stages, launches,
                             "stage_se2_")
    out["stage_se2_same_points"] = _same_share(fused.points, ref.points)
    kt.set_seed(seed)
    with _on_gibbs_twin():
        twin = _timed_product(lambda: sa * sb, sync, stages, launches,
                              "twin_se2_")
    out["twin_se2_same_points"] = _same_share(fused.points, twin.points)
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
    with _on_stage_route():
        ref, _ = _timed("stage_batched_gibbs", sampler.sample, sync, stages,
                        launches)(seed, select=select)
    out["stage_batched_same_points"] = _same_share(pts.transpose(1, 2),
                                                   ref.transpose(1, 2))
    with _on_gibbs_twin():
        twin, _ = _timed("twin_batched_gibbs", sampler.sample, sync, stages,
                         launches)(seed, select=select)
    out["twin_batched_same_points"] = _same_share(pts.transpose(1, 2),
                                                  twin.transpose(1, 2))
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
    lone = {}
    for mode in ("cdf", "gumbel"):
        call = functools.partial(kt.prod_appx_ms_gibbs, n, [pa, pb],
                                 n_iter=5, key=seed, select=mode,
                                 diffop=(manifolds.circular_diff,))
        k2 = gibbs_select.LAUNCHES
        got = _timed(f"lone_diffop_{mode}", call, sync, stages, launches)()
        k2 = gibbs_select.LAUNCHES - k2
        with _on_gibbs_twin():
            twin = _timed(f"twin_lone_diffop_{mode}", call, sync, stages,
                          launches)()
        same = float((got[1] == twin[1]).all(dim=0).double().mean())
        lone[mode] = dict(gibbs_select_launches=k2, twin_same_labels=same,
                          finite=bool(torch.isfinite(got[0]).all()))
        # gumbel's labels equal the twin's on every chain; cdf's may part
        # at float64 CDF ties
        need = 1.0 if mode == "gumbel" else AGREE_MIN
        if dev.type == "cuda" and (k2 < 1 or not lone[mode]["finite"]
                                   or same < need):
            raise AssertionError(f"lone circular diffop, {mode}: "
                                 f"{lone[mode]}")
    out["lone_diffop"] = lone
    _launched(launches, ("refit", "se2_refit"), dev, k4=True)
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
    path is compared with, not to the path: the counts are put back after
    it."""
    from kde_tpu_torch.ops import (gibbs_chain, gibbs_select, loo_search,
                                   sharded_loo, sharded_select, tiled_eval)
    n, k, c = tiled_eval.LAUNCHES, gibbs_select.LAUNCHES, gibbs_chain.LAUNCHES
    s, s_rows = loo_search.LAUNCHES, loo_search.ROWS_LAUNCHES
    k6, k6_twin = sharded_select.LAUNCHES, sharded_select.TWIN_STAGES
    k7, k7_twin = sharded_loo.LAUNCHES, sharded_loo.TWIN_STAGES
    try:
        yield
    finally:
        tiled_eval.LAUNCHES, gibbs_select.LAUNCHES = n, k
        gibbs_chain.LAUNCHES, loo_search.LAUNCHES = c, s
        loo_search.ROWS_LAUNCHES = s_rows
        sharded_select.LAUNCHES, sharded_select.TWIN_STAGES = k6, k6_twin
        sharded_loo.LAUNCHES, sharded_loo.TWIN_STAGES = k7, k7_twin


@contextlib.contextmanager
def _counting_collectives(module=None, names=("pmax", "psum", "all_gather")):
    """Counts the calls of ``names`` in ``module`` made in the block (by
    default the kernel-sharded engine's collectives, pmax, psum and
    all_gather of parallel/gibbs_kernel_sharded.py): yields a one-item
    list that holds the count, 0 at the start of the block."""
    if module is None:
        from kde_tpu_torch.parallel import gibbs_kernel_sharded as module
    saved = {k: getattr(module, k) for k in names}
    calls = [0]

    def counted(fn):
        def wrapped(*a, **kw):
            calls[0] += 1
            return fn(*a, **kw)
        return wrapped
    for k, fn in saved.items():
        setattr(module, k, counted(fn))
    try:
        yield calls
    finally:
        for k, fn in saved.items():
            setattr(module, k, fn)


@contextlib.contextmanager
def _on_k6_twin():
    """Every selection of the kernel-sharded engine on K6's plain twins
    (the eager phases of ops/sharded_select.py, the parent's arithmetic and
    chain blocks) with the same collectives.  The run is a reference: its
    counts are not the path's."""
    from kde_tpu_torch.parallel import gibbs_kernel_sharded as gks
    saved = gks._route
    gks._route = lambda *a: "twin"
    try:
        with _uncounted():
            yield
    finally:
        gks._route = saved


def _k6_shadow_ties(call):
    """``call()`` once with every K6 selection also run on the twins on the
    same stage inputs (k6_compare, which raises on anything but a float64
    CDF tie within K6_TIE of u): returns the ties' |u - cdf|."""
    from kde_tpu_torch.ops import sharded_select as ss
    from kde_tpu_torch.parallel import gibbs_kernel_sharded as gks
    saved = gks._sharded_choose
    ties = []

    def make(mesh, d, route):
        choose = saved(mesh, d, route)

        def checked(stage, lvl):
            mean, bw, logw, stats, real, _ = lvl
            js = tuple(stage.js)
            rows = ss.Rows(mean[0], bw[0], logw[0], js, stage.mu[0],
                           None if stage.cov is None else stage.cov[0],
                           stage.active[0], stage.diffop)
            inp = dict(rows=[rows], stats=[stats[0]],
                       real=[real[js[0]:js[-1] + 1]], u=stage.u[0], js=js,
                       n_shards=1)
            with _uncounted():
                ties.extend(k6_compare(inp, "full-width shadow")["cdf_ties"])
            return choose(stage, lvl)
        return checked
    gks._sharded_choose = make
    try:
        call()
    finally:
        gks._sharded_choose = saved
    return ties


K6_BIG_N = 1_000_000     # phase 11a's full-width case: 2 x 1M, 2-D


def _k6_full_width(mesh, dev, seed, n=K6_BIG_N, chains=SERVE_CHAINS):
    """Phase 11a's full-width case: the kernel-sharded replay of
    ``chains`` chains over 2 x ``n`` float32 components in 2-D at S = 1
    on K6 against the same call on its twins (_on_k6_twin): labels at
    every level equal (where they differ, a shadow run lists every K6
    selection's float64 CDF ties, and the differing chains must not
    outnumber them), each call's seconds, collectives, chain blocks
    (collectives over 6 a selection) and allocator peak.  The plan and
    trees are built first, outside the timings."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch import parallel as par
    from kde_tpu_torch.ops import balltree, gibbs, sharded_select
    from kde_tpu_torch.parallel import gibbs_kernel_sharded as gks
    sync = _sync if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(seed + 16)
    bw = [float(1.06 * n ** -0.2)]
    dens = [kt.kde((rng.normal(size=(2, n)) + s).astype(np.float32), bw,
                   device=dev, dtype=torch.float32) for s in (0.0, 0.5)]
    ru, rn = _replay_streams(np.random.default_rng(seed + 17), chains, dens,
                             5)
    t0 = time.perf_counter()
    plan = gks._get_ks_plan(dens, chains, torch.float32, 1, 0,
                            dens[0].device)
    res = {"n": n, "chains": chains, "plan_s": time.perf_counter() - t0}
    L = balltree.n_levels(chains, [n, n])
    per_block = 6 * L * (1 + 5 * 2)
    call = lambda: par.prod_appx_ms_gibbs_kernel_sharded(
        mesh, chains, dens, n_iter=5, rand_u=ru, rand_n=rn,
        record_labels=True)

    def timed(tag):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        k0, t0w = sharded_select.LAUNCHES, sharded_select.TWIN_STAGES
        with _counting_collectives() as calls:
            sync()
            t0 = time.perf_counter()
            out = call()
            sync()
        res[f"{tag}_s"] = time.perf_counter() - t0
        res[f"{tag}_collectives"] = calls[0]
        res[f"{tag}_chain_blocks"] = calls[0] / per_block
        res[f"{tag}_launches"] = sharded_select.LAUNCHES - k0
        res[f"{tag}_twin_stages"] = sharded_select.TWIN_STAGES - t0w
        res[f"{tag}_peak_mb"] = (torch.cuda.max_memory_allocated(dev) / 1e6
                                 if dev.type == "cuda" else None)
        return out
    got = timed("k6")
    with _on_k6_twin():
        want = timed("twin")
    got = timed("k6")                    # in turns: K6, twin, K6
    want_blocks = -(-chains // gibbs._chains_per_block(
        chains, max(w for _, w in plan.offsets), 4))
    k6_blocks = 1 if dev.type == "cuda" else want_blocks   # the twins here
    if (res["k6_chain_blocks"] != k6_blocks
            or res["twin_chain_blocks"] != want_blocks
            or res["twin_launches"] or (dev.type == "cuda" and (
                res["k6_launches"] < 1 or res["k6_twin_stages"]))):
        raise AssertionError(f"full-width kernel-sharded: {res}")
    diff = (got[2] != want[2]).any(dim=2).any(dim=1)
    res["differing_chains"] = int(diff.sum())
    res["ties"] = _k6_shadow_ties(call) if bool(diff.any()) else []
    if res["differing_chains"] > len(res["ties"]):
        raise AssertionError(f"full-width kernel-sharded: "
                             f"{res['differing_chains']} chains differ from "
                             f"the twin's, {len(res['ties'])} ties")
    if not bool(torch.isfinite(got[0]).all()):
        raise AssertionError("full-width kernel-sharded: non-finite points")
    return res


K7_PHASES = ("stage", "nn_shift", "sweep", "golden_step")


@contextlib.contextmanager
def _k7_on_twin():
    """sharded_loo.search with each phase's plain twin (``*_ref``) on the
    inputs' device, in the same loop with the same collectives; a
    reference, not counted."""
    from kde_tpu_torch.ops import sharded_loo
    saved = {k: getattr(sharded_loo, k) for k in K7_PHASES}
    for k in K7_PHASES:
        setattr(sharded_loo, k, getattr(sharded_loo, k + "_ref"))
    try:
        with _uncounted():
            yield
    finally:
        for k, fn in saved.items():
            setattr(sharded_loo, k, fn)


def k7_all_reduces(mesh, sweeps):
    """The all-reduces a sharded LOOCV search of ``sweeps`` sweeps issues
    on ``mesh``: one a sweep, the psum of its entropies over every rank of
    the mesh, whatever axes it has."""
    return sweeps


def _k7_search(name, call, dev, mesh):
    """``call()``, a sharded LOOCV search on ``mesh``, with its K7
    launches and twin stages (which must be > 0 and 0 on the card), the
    all-reduces it issued (counted at torch.distributed.all_reduce, from
    0 at the call; they must be k7_all_reduces', one a sweep on any
    mesh), its sweeps, host waits and stop reason
    (sharded_loo.LAST), the lag of every flag read (the sweep issued less
    the sweep read, counted at sharded_loo._read_flag; each at least 1,
    one a wait) and the allocator's peak over the call less what was
    allocated before it.  Returns the result and those numbers."""
    import torch
    from kde_tpu_torch.ops import sharded_loo
    _sync()
    base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    k0, t0 = sharded_loo.LAUNCHES, sharded_loo.TWIN_STAGES
    read, lags = sharded_loo._read_flag, []

    def lagged(flags, events, k):
        lags.append(len(events) - 1 - k)
        return read(flags, events, k)
    sharded_loo._read_flag = lagged
    try:
        with _counting_collectives(torch.distributed,
                                   ("all_reduce",)) as calls:
            t = time.perf_counter()
            got = call()
            _sync()
            ms = 1e3 * (time.perf_counter() - t)
    finally:
        sharded_loo._read_flag = read
    row = dict(ms=ms, **sharded_loo.LAST, collectives=calls[0],
               least_lag=min(lags, default=None),
               k7_launches=sharded_loo.LAUNCHES - k0,
               k7_twin_stages=sharded_loo.TWIN_STAGES - t0)
    if dev.type == "cuda":
        row["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
        if row["k7_launches"] < 1 or row["k7_twin_stages"]:
            raise AssertionError(f"{name}: {row['k7_launches']} K7 launches, "
                                 f"{row['k7_twin_stages']} twin stages")
    # a search stopped by max_iters reads no flag after its last sweep
    waits = (row["sweeps"] - sharded_loo.FLAG_LAG
             - (row["stop"] == "max_iters"))
    if (row["collectives"] != k7_all_reduces(mesh, row["sweeps"])
            or row["host_waits"] != waits or len(lags) != waits
            or not lags or min(lags) < 1):
        raise AssertionError(f"{name}: {json.dumps(row)}")
    return got, row


def _k7_probe_rel(mesh, pts):
    """ksize_bandwidths_sharded of ``pts`` (uniform weights) with K7's
    probe trace, each probe value against the plain LOO entropy at the
    same x (ops/loo_search.py::make_nloo, the eager probe of K4's twin;
    independent of K7's loop): the largest relative gap of the finite
    values (the others must be equal), as k4_compare holds K4's."""
    import torch
    from kde_tpu_torch import parallel as par
    from kde_tpu_torch.ops import loo_search, loocv, sharded_loo
    n = pts.shape[0]
    trace = loo_search.new_trace(pts.T, K4_TOL)
    saved = sharded_loo.search
    sharded_loo.search = functools.partial(saved, trace=trace)
    try:
        with _uncounted():
            par.ksize_bandwidths_sharded(mesh, pts, tol=K4_TOL)
    finally:
        sharded_loo.search = saved
    rows = pts.T.contiguous()
    base = loocv.bracket_rows(rows, *loocv._slices_on(n, pts.device))[0]
    w = torch.full((n,), 1.0 / n, dtype=pts.dtype, device=pts.device)
    with _uncounted():
        nloo = loo_search.make_nloo(rows, base ** 2, w,
                                    loocv.select_loo_impl(n, pts.dtype),
                                    1024)
        return probe_max_rel(trace, nloo, "ksize_sharded's probes")


def _device_idle(call, k7_names=K7_KERNEL_NAMES):
    """One ``call()`` under torch.profiler after a warm-up: its wall time
    on the host clock, the device's busy time (kernels, copies and sets,
    merged) and the idle share, and the busy time by kernel group (K7's
    kernels named by ``k7_names``)."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    call()
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        call()
        _sync()
        wall = 1e3 * (time.perf_counter() - t)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev_events = [e for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    busy = _merged_us([(e["ts"], e["ts"] + e["dur"])
                       for e in dev_events]) / 1e3
    groups = {}
    for e in dev_events:
        n = e["name"]
        g = ("k7" if any(k in n for k in k7_names) else
             "nccl" if "nccl" in n.lower() else e["cat"])
        groups[g] = groups.get(g, 0.0) + e["dur"] / 1e3
    return dict(wall_ms=wall, device_busy_ms=busy,
                idle_share=1.0 - busy / wall, busy_ms_by_group=groups,
                device_events=len(dev_events))


def _k7_full_width(mesh, dev, seed, n=K7_BIG_N):
    """Phase 11a's full-width search: ksize_bandwidths_sharded of ``n``
    N(0, 1) points in 2-D at S = 1 on K7, its picks within K4's final
    bracket of K4's single-card search on the same points."""
    import torch
    from kde_tpu_torch import parallel as par
    from kde_tpu_torch.ops import loocv
    rng = np.random.default_rng(seed + 17)
    pts = torch.as_tensor(rng.normal(size=(n, 2)), dtype=torch.float32,
                          device=dev)
    par.ksize_bandwidths_sharded(mesh, pts)        # warm
    bws, row = _k7_search(f"ksize_sharded {n}",
                          lambda: par.ksize_bandwidths_sharded(mesh, pts), dev,
                          mesh)
    want = loocv.ksize_bandwidths_device(pts)
    row.update(n=n, bandwidths=bws.tolist(), k4_bandwidths=want.tolist(),
               k4_rel=float(((bws - want).abs() / want).max()))
    if not (torch.isfinite(bws).all() and row["k4_rel"] <= 2 * K4_TOL):
        raise AssertionError(f"ksize_sharded {n}: {json.dumps(row)}")
    return row


def phase_parallel(dev, p, q, serve, b=BATCH_SETS, seed=SEED):
    """Phase 11a: the sharded entry points in a one-rank NCCL world, each
    against its unsharded counterpart at full width.  The references'
    kernel launches stay out of the path's count."""
    import torch
    import torch.distributed as dist
    import kde_tpu_torch as kt
    from kde_tpu_torch import config, parallel as par
    from kde_tpu_torch.ops import kernels, loocv
    from kde_tpu_torch.ops import gibbs_chain, sharded_select
    from kde_tpu_torch.parallel import product as par_product
    from kde_tpu_torch.parallel.scaling_bench import comm_table
    stages, launches, out, k3 = {}, {}, {}, {}

    def stage(name, fn, *args, **kw):
        n0 = gibbs_chain.LAUNCHES
        res = _timed(name, fn, _sync, stages, launches)(*args, **kw)
        k3[name] = k3.get(name, 0) + gibbs_chain.LAUNCHES - n0
        return res

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
        # sharded `*`: the refit launches K4, the result stays on the card
        pq = _timed_product(
            lambda: par.product_sharded(mesh, [p, q], key=seed), _sync,
            stages, launches, "sharded_", where=par_product)
        out["sharded_mean"] = _check_mean(pq, 0.25, "product_sharded", n)
        if pq._host_points is not None or pq._tree is not None \
                or pq.device.type != dev.type:
            raise AssertionError("product_sharded left the device")

        # kernel-sharded replay (S = 1) on K6 against the plain engine,
        # timed in turns (sharded, plain, plain, sharded)
        dens = serve.densities
        ru, rn = _replay_streams(np.random.default_rng(seed + 11),
                                 SERVE_CHAINS, dens, 5)
        ks = lambda: par.prod_appx_ms_gibbs_kernel_sharded(
            mesh2, SERVE_CHAINS, dens, n_iter=5, rand_u=ru, rand_n=rn)
        plain = lambda: kt.prod_appx_ms_gibbs(SERVE_CHAINS, dens, n_iter=5,
                                              rand_u=ru, rand_n=rn)
        with _uncounted():
            want = plain()[1]
        k0, t0 = sharded_select.LAUNCHES, sharded_select.TWIN_STAGES
        with _counting_collectives() as calls:
            got = ks()[1]
        out["kernel_k6_launches"] = sharded_select.LAUNCHES - k0
        out["kernel_k6_twin_stages"] = sharded_select.TWIN_STAGES - t0
        if out["kernel_k6_launches"] < 1 or out["kernel_k6_twin_stages"]:
            raise AssertionError(f"kernel-sharded replay: "
                                 f"{out['kernel_k6_launches']} K6 launches, "
                                 f"{out['kernel_k6_twin_stages']} twin "
                                 "stages")
        out["kernel_agree"] = _agree(got, want, "kernel-sharded")
        comm = comm_table(SERVE_CHAINS, N_SERVE, 2, 5, shards=1, device=dev)
        out["kernel_collectives"] = calls[0]
        out["kernel_chain_blocks"] = comm["chain_blocks"]
        if calls[0] != comm["collective_calls_per_product"]:
            raise AssertionError(f"kernel-sharded replay: {calls[0]} "
                                 f"collectives, comm_table says "
                                 f"{comm['collective_calls_per_product']}")
        turns = {"sharded": [], "plain": []}
        for name in ("sharded", "plain", "plain", "sharded"):
            with _uncounted():
                turns[name].append(_host_ms(ks if name == "sharded"
                                            else plain, _sync))
        out["kernel_sharded_ms_turns"] = turns["sharded"]
        out["kernel_plain_ms_turns"] = turns["plain"]
        out["kernel_sharded_ms"] = float(np.mean(turns["sharded"]))
        out["kernel_plain_ms"] = float(np.mean(turns["plain"]))
        out["kernel_s1_overhead"] = (out["kernel_sharded_ms"]
                                     / out["kernel_plain_ms"])
        with _uncounted():
            out["kernel_full_width"] = _k6_full_width(mesh2, dev, seed)

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
        out["loo_full_width"] = _loo_full_width(mesh2, dev, seed, stage)
        if N_LOO_DENSE ** 2 > config.DIRECT_PAIR_LIMIT:
            raise AssertionError(f"N_LOO_DENSE {N_LOO_DENSE} is above the "
                                 "gate")
        dense = (pq.points[:N_LOO_DENSE].contiguous(),
                 pq.bw[:N_LOO_DENSE].contiguous(),
                 torch.full((N_LOO_DENSE,), 1.0 / N_LOO_DENSE,
                            dtype=pts.dtype, device=dev))
        hd = stage("sharded_loo_entropy_dense", par.sharded_loo_entropy,
                   mesh2, *dense)
        with _uncounted():
            want = kernels.entropy_kernel(*dense)
        out["loo_dense_rel"] = abs(float(hd) / float(want) - 1.0)
        if not (hd.is_cuda and out["loo_dense_rel"] <= RTOL
                and launches["sharded_loo_entropy_dense"] == 0
                and launches["sharded_loo_entropy_dense_k4"] == 0):
            raise AssertionError(
                f"sharded_loo_entropy below the gate: on {hd.device}, "
                f"{out['loo_dense_rel']} from entropy_kernel, "
                f"{launches['sharded_loo_entropy_dense']} K1 launches")
        pts = pq.points[:N_KSIZE].contiguous()
        bws, out["ksize"] = _k7_search(
            "ksize_sharded", lambda: stage("ksize_sharded",
                                           par.ksize_bandwidths_sharded,
                                           mesh2, pts), dev, mesh2)
        # against the single-device search on the same eager probes (K4's
        # twin) and within K4's final bracket of K4 itself; K7's probe
        # values against the eager entropy at the same x
        with _k4_on_twin():
            ksize_twin = loocv.ksize_bandwidths_device(pts)
        with _uncounted():
            ksize_dev = loocv.ksize_bandwidths_device(pts)
        out["ksize_rel"] = float(((bws - ksize_twin).abs()
                                  / ksize_twin).max())
        out["ksize_k4_rel"] = float(((bws - ksize_dev).abs()
                                     / ksize_dev).max())
        out["ksize_probe_rel"] = _k7_probe_rel(mesh2, pts)
        if (out["loo_rel"] > RTOL or out["ksize_rel"] > KSIZE_RTOL
                or out["ksize_k4_rel"] > 2 * K4_TOL
                or out["ksize_probe_rel"] > K4_PROBE_RTOL):
            raise AssertionError(f"sharded LOOCV: entropy {out['loo_rel']}, "
                                 f"bandwidths {out['ksize_rel']} from K4's "
                                 f"twin, {out['ksize_k4_rel']} from K4, "
                                 f"probes {out['ksize_probe_rel']} from the "
                                 "eager entropy")
        with _uncounted():
            out["ksize_idle"] = _device_idle(
                lambda: par.ksize_bandwidths_sharded(mesh2, pts))
            out["ksize_full_width"] = _k7_full_width(mesh2, dev, seed)
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
            out["sizing"] = _sizing(dev, [
                (serve.densities, SERVE_CHAINS, "cdf"), ([p, q], n, "cdf"),
                (serve.densities, SERVE_CHAINS, "gumbel"),
                ([p, q], n, "gumbel")], seed)
        for name in ("ksize_sharded", "ksize_sharded_numpy"):
            if launches[name] or launches[name + "_k4"]:
                raise AssertionError(f"{name}: {launches[name]} K1 and "
                                     f"{launches[name + '_k4']} K4 launches")
        for name in ("sharded_loo_entropy", "sharded_loo_entropy_numpy",
                     "sharded_loo_entropy_full_width"):
            if launches[name] != 1:
                raise AssertionError(f"{name}: {launches[name]} K1 launches, "
                                     "not one")
        _launched(launches, ("sharded_refit", "batched_sharded"), dev,
                  k4=True)
        _launched(launches, ("sharded_log_eval", "sharded_log_eval_numpy"),
                  dev)
        _launched(k3, ("chain_sharded", "batched_sharded"), dev)
        out["gibbs_chain_launches"] = k3
    finally:
        dist.destroy_process_group()
    out["scaling"] = phase_scaling()
    return dict(seconds=stages, launches=launches, **out)


def loo_points(n, seed, dev):
    """``n`` N(0, 1) 2-D float32 points on ``dev`` with Silverman's
    bandwidth (as variances) and uniform weights: the sharded LOO
    entropy's inputs."""
    import torch
    pts = np.random.default_rng(seed).normal(size=(n, 2))
    var = np.full((n, 2), (1.06 * n ** -0.2) ** 2)
    return [torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (pts, var, np.full(n, 1.0 / n))]


def _loo_full_width(mesh, dev, seed, stage, n=N_LOO_BIG):
    """Phase 11a's full-width LOO entropy: ``n`` 2-D points on the (1, 1)
    mesh, one K1 launch (counted, as the stage
    ``sharded_loo_entropy_full_width``) against the single-device
    ``entropy_kernel`` (K1, uncounted) within RTOL; its host ms and
    allocator peak above its inputs (under LOO_PEAK_BYTES: no [N, N]
    block), the CUDA-event ms of the call and of K1 alone."""
    import torch
    from kde_tpu_torch import parallel as par
    from kde_tpu_torch.ops import kernels, tiled_eval
    args = loo_points(n, seed + 17, dev)
    call = functools.partial(par.sharded_loo_entropy, mesh, *args)
    row, got = _peak_run(lambda: stage("sharded_loo_entropy_full_width",
                                       call), dev)
    if got is None:
        raise AssertionError(f"sharded_loo_entropy at {n}: {row}")
    with _uncounted():
        want = kernels.entropy_kernel(*args)
        row["rel"] = abs(float(got) / float(want) - 1.0)
        row["cuda_ms"] = _cuda_ms(call)
        row["k1_ms"] = _cuda_ms(functools.partial(
            tiled_eval.tiled_log_eval, args[0], *args, loo=True))
    row["n"], row["input_bytes"] = n, sum(a.nbytes for a in args)
    if not (torch.isfinite(got) and row["rel"] <= RTOL
            and (dev.type != "cuda" or row["peak_bytes"] < LOO_PEAK_BYTES)):
        raise AssertionError(f"sharded_loo_entropy at {n}: {row}")
    return row


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


def phase_tools(dev):
    """Phase 13: the quick rows of tools_torch/validate_cuda.py (all must
    pass, the controls must fail the brackets, and the rows must cover
    K3's warp, block and staged layouts with cdf and with gumbel), the
    envelope's mem stage at ENVELOPE_NS for cdf and gumbel (estimate /
    peak within SIZING_BAND) and its time stage at 400k, cdf against
    gumbel, one round, each one gibbs_chain launch and no gibbs_select
    launch a call; one line each."""
    from tools_torch import scale_envelope, validate_cuda
    out = {}
    t0 = time.perf_counter()
    val = validate_cuda.run(dev, validate_cuda.QUICK,
                            log=lambda *a, **k: None)
    out["validate"] = dict(seconds=time.perf_counter() - t0, rows=[
        {k: r[k] for k in ("name", "select", "layout", "wins", "of", "need",
                           "passed", "seconds", "k3_launches")}
        for r in val["rows"]])
    print(f"tools validate_cuda quick rows: {json.dumps(out['validate'])}",
          flush=True)
    failed = [r["name"] for r in val["rows"] if not r["passed"]]
    for select in ("cdf", "gumbel"):
        layouts = {r["layout"] for r in val["rows"]
                   if r["select"] == select}
        if failed or not {"warp", "block", "staged"} <= layouts:
            raise AssertionError(f"validate_cuda: rows {failed} failed; "
                                 f"{select} layouts {sorted(layouts)}")
    t0 = time.perf_counter()
    mem = scale_envelope.mem_stage(ENVELOPE_NS, ("cdf", "gumbel"),
                                   device=dev)
    out["mem"] = dict(seconds=time.perf_counter() - t0, rows=mem["rows"])
    print(f"tools scale_envelope mem: {json.dumps(out['mem'])}", flush=True)
    bad = [r for r in mem["rows"] if "ratio" not in r
           or not SIZING_BAND[0] <= r["ratio"] <= SIZING_BAND[1]]
    if bad:
        raise AssertionError(f"scale_envelope mem: estimate / peak outside "
                             f"{SIZING_BAND}: {bad}")
    t0 = time.perf_counter()
    tm = scale_envelope.time_stage((ENVELOPE_NS[-1],), ("cdf", "gumbel"),
                                   rounds=1, device=dev)
    out["time"] = dict(seconds=time.perf_counter() - t0, rows=tm["rows"],
                       overtakes_cdf=tm["overtakes_cdf"])
    print(f"tools scale_envelope time: {json.dumps(out['time'])}",
          flush=True)
    if any("samples_per_s" not in r or (dev.type == "cuda" and (
            r["k3_launches"], r["k2_launches"]) != (1, 0))
           for r in tm["rows"]):
        raise AssertionError(f"scale_envelope time: {tm['rows']}")
    return out


def _sizing(dev, cases, seed):
    """estimate_product_memory against the allocator's peak over the keyed
    product of device-resident copies (a fresh plan, built in the window
    with the topology cache emptied, as a process's first product of that
    size builds it), for each ``(densities, chains, select)`` of
    ``cases``."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import device_plan
    from kde_tpu_torch.parallel import estimate_product_memory
    rows = {}
    for dens, n_out, select in cases:
        copies = [kt.KDE(k.points, k.bw, k.weights) for k in dens]
        device_plan._topology_on.cache_clear()
        _sync()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        kt.prod_appx_ms_gibbs(n_out, copies, n_iter=5, key=seed,
                              select=select)
        _sync()
        peak = torch.cuda.max_memory_allocated(dev) - base
        est = estimate_product_memory(copies, n_out, n_iter=5,
                                      dtype=torch.float32, select=select)
        ratio = est["total"] / peak
        rows[f"2x{dens[0].npts}/{n_out} {select}"] = dict(
            estimate=est, peak=peak, ratio=ratio)
        if not SIZING_BAND[0] <= ratio <= SIZING_BAND[1]:
            raise AssertionError(f"sizing 2x{dens[0].npts}, {n_out} chains, "
                                 f"{select}: estimate/peak {ratio}")
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
    from kde_tpu_torch.ops import sharded_select
    k0, s0 = sharded_select.LAUNCHES, sharded_select.TWIN_STAGES
    t0 = time.perf_counter()
    _, idx = par.prod_appx_ms_gibbs_kernel_sharded(
        kmesh, SHARED_CHAINS, dens, n_iter=5, rand_u=ru, rand_n=rn)
    _sync()
    out["kernel_sharded_s"] = time.perf_counter() - t0
    out["k6_launches"] = sharded_select.LAUNCHES - k0
    out["k6_twin_stages"] = sharded_select.TWIN_STAGES - s0
    if out["k6_launches"] < 1 or out["k6_twin_stages"]:
        raise AssertionError(f"kernel-sharded S = 2: {out['k6_launches']} "
                             f"K6 launches, {out['k6_twin_stages']} twin "
                             "stages")
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
    # the sharded LOOCV search with the queries split over the two ranks,
    # on K7 on each, against rank 0's single-card search (K4)
    from kde_tpu_torch.ops import loocv
    pts = torch.as_tensor(np.random.default_rng(SEED + 16).normal(
        size=(N_KSIZE, 2)), dtype=torch.float32, device=dev)
    # the queries split over both ranks, every column on each: one
    # all-reduce a sweep
    bws, counts = _k7_search(
        "ksize_bandwidths_sharded S = 2",
        lambda: par.ksize_bandwidths_sharded(kmesh, pts), dev, kmesh)
    out["ksize_sharded_s"] = counts["ms"] / 1e3
    out["ksize_bandwidths"] = bws.tolist()
    out["ksize_counts"] = counts
    out["k7_launches"] = counts["k7_launches"]
    out["k7_twin_stages"] = counts["k7_twin_stages"]
    if not bws.is_cuda:
        raise AssertionError(f"ksize_bandwidths_sharded S = 2 on "
                             f"{bws.device}")
    if rank == 0:
        want = loocv.ksize_bandwidths_device(pts)
        out["ksize_k4_rel"] = float(((bws - want).abs() / want).max())
        if out["ksize_k4_rel"] > 2 * K4_TOL:
            raise AssertionError(f"ksize_bandwidths_sharded S = 2: "
                                 f"{out['ksize_k4_rel']} from K4's picks")
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
    out.update(_shared_card_loo(rank, kmesh, par.make_mesh_2d((2, 1)), dev))
    torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)


def _shared_card_loo(rank, kmesh, cmesh, dev):
    """Phase 11b's LOO entropy of N_LOO 2-D points with the components
    split over the two ranks (``kmesh``: this rank's offset -rank N/2) and
    with the queries split (``cmesh``, chains 2 x kernels 1: +rank N/2):
    one K1 launch a call on each rank with that offset, the entropy
    within RTOL of the single-device ``entropy_kernel``."""
    from kde_tpu_torch import parallel as par
    from kde_tpu_torch.ops import kernels, tiled_eval
    args = loo_points(N_LOO, SEED + 18, dev)
    out, diags = {"loo_launches": 0}, []
    launch = kernels.tiled_log_eval

    def recording(*a, **kw):
        diags.append(kw["diag"])
        return launch(*a, **kw)
    kernels.tiled_log_eval = recording
    try:
        for name, mesh, diag in (("kernels", kmesh, -rank * N_LOO // 2),
                                 ("chains", cmesh, rank * N_LOO // 2)):
            n0, t0 = tiled_eval.LAUNCHES, time.perf_counter()
            h = par.sharded_loo_entropy(mesh, *args)
            _sync()
            out[f"loo_{name}_s"] = time.perf_counter() - t0
            n = tiled_eval.LAUNCHES - n0
            out["loo_launches"] += n
            if n != 1 or diags[-1:] != [diag] or h.device != dev:
                raise AssertionError(f"sharded_loo_entropy S = 2 over "
                                     f"{name}: {n} K1 launches, offsets "
                                     f"{diags}, not {diag}; on {h.device}")
            out[f"loo_{name}"] = float(h)
    finally:
        kernels.tiled_log_eval = launch
    out["loo_diags"] = diags
    want = float(kernels.entropy_kernel(*args))
    out["loo_rel"] = max(abs(out[f"loo_{k}"] / want - 1.0)
                         for k in ("kernels", "chains"))
    if out["loo_rel"] > RTOL:
        raise AssertionError(f"sharded_loo_entropy S = 2: {out['loo_rel']} "
                             f"from entropy_kernel")
    return out


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
    checkout's twin and give the same bits (each side's wrapper calls its
    own library with its own C signature: the parent's takes no diagonal
    offset); each side is timed single-call and back-to-back
    (``_cuda_ms``), beside the bound (``k1_bound_ms``); first each
    library's ptxas registers, shared memory and spills by kernel, where
    this run built it.  Then the host cost
    of one wrapper call at 128 x 128, every plan of ``tiled_eval.plans`` at
    K1_SWEEP's shapes (back-to-back, one launch each), the SM clock under
    K1, and the sharded LOO entropy against the parent's
    (``k1_parent_loo``)."""
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
        table = (ptxas_table(mod.BUILD_LOG)
                 or "library already built: no ptxas output")
        print(f"k1 ptxas ({name}): {json.dumps(table)}", flush=True)
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
        got = {}
        for name, mod in mods.items():
            got[name] = mod.tiled_log_eval(*args, loo=loo)
            _sync()
            row[f"{name}_max_abs_err"] = compare(got[name], want,
                                                 f"{name} ({shape})")
        row["bitwise"] = torch.equal(got["parent"], got["change"])
        if not row["bitwise"]:
            raise AssertionError(f"K1 ({shape}): not the parent's bits")
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
    k1_parent_loo(parent, dev)
    print(_card())


def k1_parent_loo(parent, dev, ns=(N_LOO, N_LOO_BIG)):
    """The sharded LOO entropy of ``n`` 2-D points (``loo_points``) on a
    one-rank (1, 1) mesh (NCCL; gloo off the card), this checkout's
    against ``parent``'s ``parallel/eval.py`` (loaded as a module of this
    package, ``_parent_module``), in turns: change, parent, parent,
    change.  Each turn's host ms, allocator peak above its inputs and
    entropy, or the out-of-memory error and the peak reached; one line a
    size."""
    import torch.distributed as dist
    from kde_tpu_torch import parallel as par
    from kde_tpu_torch.parallel import eval as ev
    mods = {"change": ev, "parent": _parent_module(parent, "parallel",
                                                   "eval")}
    par.initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                             backend="nccl" if dev.type == "cuda" else "gloo",
                             timeout=WORKER_TIMEOUT)
    try:
        mesh = par.make_mesh_2d((1, 1))
        for n in ns:
            args = loo_points(n, SEED + 17, dev)
            row = {"n": n, "input_bytes": sum(a.nbytes for a in args)}
            for name in ("change", "parent", "parent", "change"):
                call = functools.partial(mods[name].sharded_loo_entropy,
                                         mesh, *args)
                row.setdefault(name, []).append(_peak_run(call, dev)[0])
            print(f"k1 sharded_loo_entropy ab: {json.dumps(row)}",
                  flush=True)
            del args
    finally:
        dist.destroy_process_group()


def small_parent_ab(parent):
    """Time this checkout's small-route kernels against ``parent``'s (the
    ``csrc/small_ops.cu`` of another checkout, e.g. an unpacked ``git
    archive`` of the commit before the cluster search, built here with the
    same flags) on this card, in turns: parent, change, change, parent.
    The parent's ``ksize_small`` is its wrapper's sequence: the node table
    copied to the card, the torch ``bracket_rows``, one search launch of
    one block a row, ``* base`` (its device time comes from a graph of the
    same sequence with the table uploaded before: a copy from pageable
    host memory cannot be captured); its ``small_log_eval`` has this
    checkout's C signature.  Each side must match this checkout's twin
    (rtol 1e-9 / atol 1e-10) and is timed as phase 3b times it
    (``_timings``)."""
    import ctypes
    from pathlib import Path
    import torch
    from kde_tpu_torch.ops import host_small, loocv, tiled_eval
    src = Path(parent).resolve() / "kde_tpu_torch" / "csrc" / "small_ops.cu"
    so, _ = tiled_eval.nvcc_build(src, host_small.NVCC_FLAGS,
                                  "small_ops_parent")
    old = ctypes.CDLL(str(so))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    old.kde_loo_golden.argtypes = [vp] * 7 + [i, i, f, i, f, f, vp]
    old.kde_loo_golden.restype = i
    old.kde_small_log_eval.argtypes = [vp] * 5 + [i] * 4 + [vp]
    old.kde_small_log_eval.restype = i
    new = host_small._load()
    dev = torch.device("cuda")
    stream = lambda: torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device())

    def parent_ksize(x, w, table=None):
        r, n = x.shape
        base, ax, bx, cx = loocv.bracket_rows(
            x, *(table or loocv._slices_on(n, dev)))
        bv = base ** 2
        xmin = torch.empty(r, dtype=torch.float64, device=dev)
        host_small._checked("parent kde_loo_golden", old.kde_loo_golden(
            x.data_ptr(), w.data_ptr(), bv.data_ptr(), ax.data_ptr(),
            bx.data_ptr(), cx.data_ptr(), xmin.data_ptr(), r, n, SMALL_TOL,
            host_small.golden_max_iters(SMALL_TOL), loocv._C, loocv._R,
            stream()))
        return xmin * base

    def with_lib(lib, fn):
        def call():
            host_small._lib = lib
            try:
                return fn()
            finally:
                host_small._lib = new
        return call

    for name in ("cfg1", "d2", "gate_edge"):
        x, w = _golden_inputs(name, dev)
        want = host_small.ksize_small_ref(x, w, SMALL_TOL)
        calls = {"parent": lambda: parent_ksize(x, w),
                 "change": lambda: host_small.ksize_small(x, w, SMALL_TOL)}
        row = {"N": x.shape[1], "R": x.shape[0],
               "cluster": host_small._cluster(*x.shape, x.device, None)}
        for side, call in calls.items():
            row[f"{side}_rel_err"] = _rel(call(), want)
            if row[f"{side}_rel_err"] > SMALL_RTOL:
                raise AssertionError(f"{side} ksize_small ({name}) off the "
                                     "twin")
        table = loocv._slices_on(x.shape[1], dev)
        graph_calls = {"parent": lambda: parent_ksize(x, w, table),
                       "change": calls["change"]}
        for side in ("parent", "change", "change", "parent"):
            for k, v in _timings(calls[side],
                                 graph_call=graph_calls[side]).items():
                row.setdefault(f"{side}_{k}", []).append(v)
        print(f"small ab ksize_small ({name}): {json.dumps(row)}", flush=True)
    for name in ("cfg1", "widest"):
        (q, mu, var, w), loo = _eval_inputs(name, dev)
        want = host_small.small_log_eval_ref(q, mu, var, w, loo)
        fn = functools.partial(host_small.log_eval_small, q, mu, var, w)
        calls = {"parent": with_lib(old, fn), "change": with_lib(new, fn)}
        row = {"M": q.shape[0], "N": mu.shape[0], "d": q.shape[1]}
        for side, call in calls.items():
            row[f"{side}_max_abs_err"] = float((call() - want).abs().max())
            if row[f"{side}_max_abs_err"] > SMALL_ATOL:
                raise AssertionError(f"{side} small_log_eval ({name}) off "
                                     "the twin")
        for side in ("parent", "change", "change", "parent"):
            for k, v in _timings(calls[side]).items():
                row.setdefault(f"{side}_{k}", []).append(v)
        print(f"small ab small_log_eval ({name}): {json.dumps(row)}",
              flush=True)
    print(_card())


def _k2_raw(args, codes, kw, plan, gs=None):
    """A call of ``gs``'s (default the package's) ``kde_gibbs_select``
    with ``plan`` forced (ops/gibbs_select.py::launch_plan picks it on the
    package's path), uncounted, into fresh outputs; returns the
    labels."""
    if gs is None:
        from kde_tpu_torch.ops import gibbs_select as gs
    lib = gs._load()
    return lambda: gs._launch(lib, plan, *args, codes, kw["u"],
                              kw.get("seeds"), kw.get("chain0", 0),
                              kw.get("sel0", 0), kw.get("uniform"))[2]


def _k2_layouts(gs, w, d, item, gumbel):
    """The layouts ``--k2-diag`` times at a level of ``w`` candidates:
    name -> plan (the warp layout recomputing where 8 rows' logits do not
    fit; tiles only for cdf)."""
    return {name: gs.launch_plan(w, d, item, gumbel=gumbel, layout=name)
            for name in ("block", "warp") + (() if gumbel else ("tiles",))}


def _k2_layout_row(gs, args, codes, kw, plans):
    """Each plan's ms (one call, CUDA events; and 10 back to back, each
    call's host work hidden) and its labels' mismatches against the
    package's plan (0 but at float64 CDF ties)."""
    import torch
    want = gs.gibbs_select(*args, codes, **kw)[2]
    row = {}
    for name, plan in plans.items():
        call = _k2_raw(args, codes, kw, plan)
        off = int((call() != want).sum())
        if off > K2_MAX_TIES or (off and kw["u"] is None):
            raise AssertionError(f"k2 diag: layout {name} {off} labels off "
                                 "the plan's")
        row[name] = _cuda_ms(call)
        row[name + " inner10"] = _cuda_ms(call, inner=10)
        if off:
            row[name + " off"] = off
        torch.cuda.empty_cache()
    return row


def k2_switch(seed=SEED):
    """The block layout beside cdf's tiles at a sweep stage (float32, cov,
    varied bandwidths; d = 2 Euclidean as the leaf sweep and 10b's product,
    d = 1 circular as phase 10's lone diffop product) for each row count
    of K2_DIAG_ROWS over each width of K2_DIAG_WIDTHS, with the layout
    launch_plan picks there: the readings that set gibbs_select's
    TILE_MIN_ROWS."""
    import torch
    from kde_tpu_torch.ops import gibbs_select as gs
    dev = torch.device("cuda")
    for d, codes in ((2, (0, 0)), (1, (1,))):
        for w in K2_DIAG_WIDTHS:
            for rows in K2_DIAG_ROWS:
                args, codes, kw = k2_inputs(seed + 3, dev, 1, rows, 2, w, d,
                                            (0,), torch.float32, True, codes,
                                            "cdf")
                plans = {"block": gs.launch_plan(w, d, 4, layout="block"),
                         "tiles": gs.launch_plan(w, d, 4, layout="tiles")}
                row = _k2_layout_row(gs, args, codes, kw, plans)
                row["plan"] = gs.launch_plan(w, d, 4, rows=rows).layout
                print(f"k2 diag switch, d = {d}, {rows} rows over {w}, ms: "
                      f"{json.dumps(row)}", flush=True)
                del args, kw


def k2_diag(seed=SEED):
    """Where K2's time goes on this card, each layout forced through the C
    entry (``_k2_raw``) and checked against the plan's labels: the leaf
    sweep and conditioning stages (20,000 chains x 20,000 candidates) with
    varied and uniform bandwidths under the block layout (logits cached),
    a warp a row, and cdf's tiles; the switch between the block layout
    and the tiles (``k2_switch``, which sets gibbs_select's
    TILE_MIN_ROWS); gumbel at the leaf and serve shapes
    (256 x 50,000); the wrapper's host microseconds a call beside its bare
    launch (2,000 calls at a tiny shape); and a serve request (2 x 50,000,
    256 chains) as is and with gibbs_select's outputs precomputed (no
    launch, no wrapper), so the eager ops around K2 are timed alone."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import gibbs_select as gs
    dev = torch.device("cuda")
    gs.build()
    print(f"k2 diag ptxas: {json.dumps(ptxas_table(gs.BUILD_LOG))}",
          flush=True)
    f32 = torch.float32
    for name, js, uni in (("leaf sweep", (0,), False),
                          ("leaf sweep uniform", (0,), True),
                          ("leaf cond", (0, 1), False),
                          ("leaf cond uniform", (0, 1), True)):
        args, codes, kw = k2_inputs(seed + 1, dev, 1, N_SLICE, 2, N_SLICE, 2,
                                    js, f32, len(js) == 1, (0, 0), "cdf",
                                    uniform=uni)
        row = _k2_layout_row(gs, args, codes, kw,
                             _k2_layouts(gs, N_SLICE, 2, 4, False))
        print(f"k2 diag {name} cdf, ms by layout: {json.dumps(row)}",
              flush=True)
        del args, kw
    k2_switch(seed)
    for shape, (c, w) in (("leaf", (N_SLICE, N_SLICE)),
                          ("serve", (SERVE_CHAINS, N_SERVE))):
        args, codes, kw = k2_inputs(seed + 1, dev, 1, c, 2, w, 2, (1,), f32,
                                    True, (0, 0), "gumbel")
        row = _k2_layout_row(gs, args, codes, kw,
                             _k2_layouts(gs, w, 2, 4, True))
        print(f"k2 diag {shape} gumbel, ms by layout: {json.dumps(row)}",
              flush=True)
        del args, kw
    args, codes, kw = k2_inputs(seed + 2, dev, 1, 8, 2, 16, 2, (0,), f32,
                                True, (0, 0), "cdf")
    calls = {"wrapper": functools.partial(gs.gibbs_select, *args, codes,
                                          **kw),
             "launch": _k2_raw(args, codes, kw, gs.launch_plan(16, 2, 4))}
    host = {}
    for name in ("wrapper", "launch", "launch", "wrapper"):
        calls[name]()
        _sync()
        t0 = time.perf_counter()
        for _ in range(K1_HOST_CALLS):
            calls[name]()
        _sync()
        host.setdefault(name, []).append(
            1e6 * (time.perf_counter() - t0) / K1_HOST_CALLS)
    print(f"k2 diag host us per call: {json.dumps(host)}", flush=True)
    rng = np.random.default_rng(seed + 1)
    bw = [float(1.06 * N_SERVE ** -0.2)]
    dens = [kt.kde((rng.normal(size=(2, N_SERVE)) + s).astype(np.float32),
                   bw, device=dev, dtype=f32) for s in (0.0, 0.5)]
    sampler = kt.ProductSampler(dens, n_out=SERVE_CHAINS, n_iter=5)
    real, outs = gs.gibbs_select, {}

    def precomputed(lm, lb, lw, lp, js, mu, cov, act, codes, u=None,
                    seeds=None, chain0=0, sel0=0, uniform=None):
        key = (tuple(mu.shape), len(js))
        if key not in outs:
            b, c, d = mu.shape
            outs[key] = (torch.zeros((b, c, len(js), d), device=dev),
                         torch.ones((b, c, len(js), d), device=dev),
                         torch.zeros((b, c, len(js)), dtype=torch.int64,
                                     device=dev))
        return outs[key]
    for select in ("gumbel", "cdf"):
        row = {}
        for name in ("kernel", "precomputed", "precomputed", "kernel"):
            gs.gibbs_select = real if name == "kernel" else precomputed
            try:
                with _on_stage_route():
                    row.setdefault(name, []).append(_host_ms(
                        lambda: sampler.sample(seed, select=select), _sync))
            finally:
                gs.gibbs_select = real
        print(f"k2 diag serve request ms, {select}: {json.dumps(row)}",
              flush=True)
    print(_card())


# --k3-diag: each ablation is csrc/gibbs_chain.cu built with -DK3_DIAG and
# its define into a library of its own (the package's build takes none)
K3_ABLATIONS = {"base": (), "a_pass2_only": ("-DK3_DIAG_PASS2_ONLY",),
                "b_no_loads": ("-DK3_DIAG_NO_LOADS",),
                "c_no_log": ("-DK3_DIAG_NO_LOG",),
                "d_div_mul": ("-DK3_DIAG_DIV_MUL",),
                "e_no_rng": ("-DK3_DIAG_NO_RNG",)}


def k3_diag_libs():
    """Every ablation of K3_ABLATIONS built at once: {name: (library bound
    by gibbs_chain.bind, nvcc's output, the .so's path)}."""
    from concurrent.futures import ThreadPoolExecutor
    from kde_tpu_torch.ops import gibbs_chain, tiled_eval

    def one(item):
        name, defs = item
        so, log = tiled_eval.nvcc_build(
            gibbs_chain.SOURCE, [*gibbs_chain.NVCC_FLAGS, "-DK3_DIAG", *defs],
            f"gibbs_chain_diag_{name}")
        return name, so, log
    with ThreadPoolExecutor(len(K3_ABLATIONS)) as pool:
        built = list(pool.map(one, K3_ABLATIONS.items()))
    return {name: (gibbs_chain.bind(so), log, so) for name, so, log in built}


SASS_CLASSES = ("MUFU", "FCHK", "CALL", "BRA", "FFMA", "FMUL", "FADD",
                "FSETP", "FSEL", "LDS", "LDG", "LD", "DADD", "F2F")


def sass_counts(so, name_part):
    """Static SASS instructions (NOPs left out) of each kernel of the
    library ``so`` whose name holds ``name_part``, and their counts by
    opcode for SASS_CLASSES, from ``cuobjdump -sass``; None where the
    toolkit has no cuobjdump."""
    import re
    from pathlib import Path
    from kde_tpu_torch.ops import tiled_eval
    tool = Path(tiled_eval._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    res = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        return {"error": res.stderr[-300:]}
    table, name = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if name_part in m.group(1) else None
            if name:
                table[name] = dict.fromkeys(("instructions",) + SASS_CLASSES,
                                            0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_]*)", line)
        if name and m and m.group(1) != "NOP":
            row = table[name]
            row["instructions"] += 1
            if m.group(1) in row:
                row[m.group(1)] += 1
    return table


K3_SWEEP_WIDTHS = (1000, 10_000, N_SERVE)     # components a density
K3_SWEEP_CHAINS = (256, 1024, 2048, 4096)


def k3_diag(seed=SEED):
    """Where K3's time goes on this card: at the slice (20,000 chains over
    2 x 20,000, d = 2, float32, Niter 5) and at serve (256 chains over
    2 x 50,000), the warp and block layouts and the staged layout, each
    timed one call between CUDA events (_cuda_ms) with every ablation of
    K3_ABLATIONS (the base build checked equal to the package's call; cdf
    with every ablation but e_no_rng, gumbel with the base and e_no_rng,
    its counter generator replaced by a few integer operations);
    then the switch between the layouts: chains (K3_SWEEP_CHAINS) over 2
    densities of K3_SWEEP_WIDTHS components, cdf and gumbel, the warp or
    block layout against the staged layout in turns (plan, staged, staged,
    plan), each checked equal to the other; last each build's ptxas registers, spills
    and shared memory, and the SASS of one logit at d = 2
    (k3_logit_probe) by cuobjdump."""
    import torch
    from kde_tpu_torch.ops import gibbs_chain
    dev = torch.device("cuda")
    libs = k3_diag_libs()
    base = libs["base"][0]
    f32 = torch.float32
    shapes = {"slice": (N_SLICE, {}),
              "serve": (N_SERVE, dict(n_out=SERVE_CHAINS))}
    layouts = {"slice": ["warp", "staged"],
               "serve": ["block", "warp", "staged"]}

    def same(got, want):
        return all(torch.equal(g, x) for g, x in zip(got, want))
    for (shape, (n, kw)), select in ((sh, sel) for sh in shapes.items()
                                     for sel in ("cdf", "gumbel")):
        args = chain_inputs(seed + 60, dev, f32, n, select=select, **kw)
        want = gibbs_chain.gibbs_chain(*args)
        w = max(w for _, w in args[2].offsets)
        print(f"k3 diag {shape} {select}: plan "
              f"{gibbs_chain.launch_plan(args[1].shape[1], w, f32, 2)}",
              flush=True)
        # _launch takes gumbel's seeds in place of cdf's stream
        launch_args = args[:7] + args[8:] if select == "gumbel" else args
        for lay in layouts[shape]:
            row = {}
            for name, (lib, _, _) in libs.items():
                if (name == "e_no_rng") != (select == "gumbel") and \
                        name != "base":
                    continue
                call = functools.partial(gibbs_chain._launch, lib, lay,
                                         *launch_args)
                if name == "base" and not same(call(), want):
                    raise AssertionError(f"k3 diag {shape} {select}: {lay} "
                                         "off the package's draw")
                row[name] = _cuda_ms(call)
            print(f"k3 diag {shape} {select} {lay}, ms by ablation: "
                  f"{json.dumps(row)}", flush=True)
        del args, want
    for n, chains, select in ((n, c, s) for n in K3_SWEEP_WIDTHS
                              for c in K3_SWEEP_CHAINS
                              for s in ("cdf", "gumbel")):
        args = chain_inputs(seed + 61, dev, f32, n, n_out=chains,
                            select=select)
        if select == "gumbel":
            args = args[:7] + args[8:]        # _launch takes the seeds last
        w = max(w for _, w in args[2].offsets)
        old = gibbs_chain.launch_plan(chains, w, torch.float64, 2)
        calls = {lay: functools.partial(gibbs_chain._launch, base, lay,
                                        *args)
                 for lay in (old, "staged")}
        if not same(calls["staged"](), calls[old]()):
            raise AssertionError(f"k3 diag switch 2 x {n}, {chains}, "
                                 f"{select}: staged off the warp / block "
                                 "draw")
        row = {"plan": gibbs_chain.launch_plan(chains, w, f32, 2)}
        for lay in (old, "staged", "staged", old):
            row.setdefault(f"{lay}_ms", []).append(_cuda_ms(calls[lay]))
        print(f"k3 diag switch, 2 x {n} components, {chains} chains, "
              f"{select}: {json.dumps(row)}", flush=True)
        del args, calls
    for name, (_, log, so) in libs.items():
        print(f"k3 diag ptxas ({name}): {json.dumps(ptxas_table(log))}",
              flush=True)
        print(f"k3 diag sass of one logit ({name}): "
              f"{json.dumps(sass_counts(so, 'probe'))}", flush=True)
    print(_card())


K3_AB_SHAPES = {"slice": (N_SLICE, {}),
                "serve": (N_SERVE, dict(n_out=SERVE_CHAINS)),
                **{k: (n, kw) for k, (_, n, kw) in K3_TIMED.items()}}


def k3_parent_ab(parent):
    """Time this checkout's K3 against ``parent``'s (the ``ops/
    gibbs_chain.py`` of another checkout, e.g. an unpacked ``git archive``,
    loaded as a module of this package so that it builds the parent's
    ``csrc/gibbs_chain.cu``) on this card, in turns: parent, change,
    change, parent, each one call between CUDA events (``_cuda_ms``), at
    the slice, serve and phase 3e's other timed shapes (K3_AB_SHAPES),
    beside ``chain_bound_ms``; both sides checked against this checkout's
    twin (``chain_compare``); then both builds' ptxas registers and
    spills, from builds of their own (``gibbs_chain_ab_<side>``), so that
    a library already in ``_build`` does not hide them."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from kde_tpu_torch.ops import gibbs_chain, tiled_eval
    path = os.path.join(os.path.abspath(parent), "kde_tpu_torch", "ops",
                        "gibbs_chain.py")
    spec = importlib.util.spec_from_file_location(
        "kde_tpu_torch.ops._k3_parent", path)
    old = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old)
    mods = {"parent": old, "change": gibbs_chain}

    def build(item):
        name, mod = item
        mod.build()
        return tiled_eval.nvcc_build(mod.SOURCE, mod.NVCC_FLAGS,
                                     f"gibbs_chain_ab_{name}")[1]
    with ThreadPoolExecutor(2) as pool:
        logs = dict(zip(mods, pool.map(build, mods.items())))
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = _sm_clock_hz()
    f32 = torch.float32
    for shape, (n, kw) in K3_AB_SHAPES.items():
        args = chain_inputs(SEED + 70, dev, f32, n, **kw)
        w = max(w for _, w in args[2].offsets)
        row = {"chains": args[1].shape[1], "sets": args[1].shape[0],
               "layout": gibbs_chain.launch_plan(args[1].shape[1], w, f32,
                                                 2)}
        row["bound_ms"], row["bound_by"] = chain_bound_ms(args, sms, clock)
        for name, mod in mods.items():
            found, _ = chain_compare(args, f"{name} {shape}", mod)
            row[f"{name}_same_share"] = found["same_share"]
            row[f"{name}_differing"] = found["differing"]
        for name in ("parent", "change", "change", "parent"):
            row.setdefault(f"{name}_ms", []).append(_cuda_ms(
                functools.partial(mods[name].gibbs_chain, *args)))
        print(f"k3 ab {shape}: {json.dumps(row)}", flush=True)
        del args
    for name, log in logs.items():
        table = {k.split("gibbs_chain")[-1][:40]: v for k, v in
                 ptxas_table(log).items()}
        if not log:
            table = "gibbs_chain_ab library already built: no ptxas output"
        print(f"k3 ab ptxas ({name}): {json.dumps(table)}", flush=True)
    print(_card())


def _parent_module(parent, pkg, name):
    """``parent``'s ``kde_tpu_torch/<pkg>/<name>.py`` loaded as a module of
    this package (``kde_tpu_torch.<pkg>._<name>_parent``), so that its
    relative imports resolve here and its build reads the parent's
    ``csrc/``."""
    path = os.path.join(os.path.abspath(parent), "kde_tpu_torch", pkg,
                        name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"kde_tpu_torch.{pkg}._{name}_parent", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


K7_PARENT_NS = (N_KSIZE, 50_000, K7_BIG_N)   # --k7-parent's searches


def _bits(t):
    import torch
    return t.contiguous().view(torch.int64 if t.element_size() == 8
                               else torch.int32)


def _peak_run(call, dev):
    """One ``call()`` ending in a sync: host ms, the allocator's peak over
    it less what was allocated before (its inputs), and its result (also
    as a list, ``result``); or, where the card runs out of memory, the
    error and the peak reached."""
    import torch
    card = dev.type == "cuda"
    peak = lambda: (torch.cuda.max_memory_allocated(dev) - base
                    if card else None)
    _sync()
    base = torch.cuda.memory_allocated(dev) if card else 0
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    try:
        got = call()
        _sync()
    except torch.cuda.OutOfMemoryError as e:
        row = dict(oom=str(e).splitlines()[0][:300], peak_bytes=peak())
        torch.cuda.empty_cache()
        return row, None
    return dict(ms=1e3 * (time.perf_counter() - t), peak_bytes=peak(),
                result=got.tolist()), got


def _k7_modules(root):
    """``(sharded_loo, eval)`` of the checkout at ``root``: this checkout's
    own modules where ``root`` is this checkout, else ``root``'s
    ``ops/sharded_loo.py`` and ``parallel/eval.py`` loaded as modules of
    this package (_parent_module), its eval bound to its sharded_loo."""
    from kde_tpu_torch.ops import sharded_loo
    from kde_tpu_torch.parallel import eval as par_eval
    if os.path.abspath(root) == os.path.dirname(os.path.abspath(__file__)):
        return sharded_loo, par_eval
    sl = _parent_module(root, "ops", "sharded_loo")
    ev = _parent_module(root, "parallel", "eval")
    ev.sharded_loo = sl
    return sl, ev


K7_WRAPPERS = ("stage", "nn_shift", "probe_sums", "probe_entropy", "sweep",
               "golden_step", "_read_flag")


def k7_split(mods, dev, n=N_KSIZE):
    """Where one sharded LOOCV search's time goes (``mods``, _k7_modules'
    pair), on ``n`` N(0, 1) 2-D float32 points at S = 1 in the open
    one-rank world: host µs a call of each K7 wrapper the search calls
    (K7_WRAPPERS, timed where they are called; ``_read_flag``, the lagged
    flag read, includes its wait), of each all-reduce (at
    torch.distributed.all_reduce) and the search's host ms ending in a
    sync; then the same search under torch.profiler (_device_idle): the
    device's busy µs a sweep by group (K7's kernels, NCCL, copies) and its
    idle share."""
    import torch
    import torch.distributed as dist
    from kde_tpu_torch import parallel as par
    sl, ev = mods
    mesh = par.make_mesh_2d((1, 1))
    pts = torch.as_tensor(np.random.default_rng(SEED + 18 + n).normal(
        size=(n, 2)), dtype=torch.float32, device=dev)
    call = functools.partial(ev.ksize_bandwidths_sharded, mesh, pts)
    call()
    _sync()
    names = [k for k in K7_WRAPPERS if hasattr(sl, k)]
    host = {k: [0.0, 0] for k in names + ["all_reduce"]}

    def timed(k, fn):
        def wrapped(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[k][0] += time.perf_counter() - t
                host[k][1] += 1
        return wrapped
    saved = {k: getattr(sl, k) for k in names}
    all_reduce = dist.all_reduce
    for k in names:
        setattr(sl, k, timed(k, saved[k]))
    dist.all_reduce = timed("all_reduce", all_reduce)
    try:
        t = time.perf_counter()
        call()
        _sync()
        wall = 1e3 * (time.perf_counter() - t)
    finally:
        for k, fn in saved.items():
            setattr(sl, k, fn)
        dist.all_reduce = all_reduce
    sweeps = sl.LAST["sweeps"]
    idle = _device_idle(call, K7_KERNEL_NAMES if hasattr(sl, "sweep")
                        else K7_PARENT_KERNEL_NAMES)
    return dict(
        n=n, sweeps=sweeps, host_ms=wall, host_us_a_sweep=1e3 * wall / sweeps,
        calls={k: v[1] for k, v in host.items()},
        host_us_a_call={k: 1e6 * v[0] / max(v[1], 1)
                        for k, v in host.items()},
        device_us_a_sweep={g: 1e3 * ms / sweeps for g, ms in
                           idle["busy_ms_by_group"].items()},
        profiled=idle)


def k7_split_main(root):
    """``--k7-split DIR``: k7_split of DIR's search alone."""
    import torch
    import torch.distributed as dist
    from kde_tpu_torch import parallel as par
    dev = torch.device("cuda")
    mods = _k7_modules(root)
    par.initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                             backend="nccl", timeout=WORKER_TIMEOUT)
    try:
        print(f"k7 split ({root}): {json.dumps(k7_split(mods, dev))}",
              flush=True)
    finally:
        dist.destroy_process_group()
    print(_card())


def k7_parent_ab(parent, dev=None, ns=K7_PARENT_NS, k4_cases=None):
    """This checkout against ``parent`` (another checkout, e.g. an unpacked
    ``git archive``) on this card.  (1) K4: ``parent``'s
    ``ops/loo_search.py``, loaded as a module of this package so that it
    builds the parent's ``csrc/loo_search.cu``, against this checkout's at
    phase 3f's seven searches (K4_CASES): picks and probe traces must be
    bitwise equal.  (2) The sharded LOOCV search: ``parent``'s
    ``parallel/eval.py::ksize_bandwidths_sharded`` on ``parent``'s
    ``ops/sharded_loo.py`` (_k7_modules) and this checkout's, S = 1 on one
    NCCL rank: k7_split of each at N_KSIZE, then the same N(0, 1) 2-D
    float32 points at each N of K7_PARENT_NS in turns (parent, change,
    change, parent): host ms of one call ending in a sync and the
    allocator's peak over it, or the parent's out-of-memory error; at
    N_KSIZE also phase 3h's CUDA-event ms (_cuda_ms)."""
    import hashlib
    import torch
    import torch.distributed as dist
    from kde_tpu_torch import parallel as par
    from kde_tpu_torch.ops import loo_search
    dev = dev or torch.device("cuda")
    here = os.path.dirname(os.path.abspath(__file__))
    mods = {"parent": _k7_modules(parent), "change": _k7_modules(here)}
    sides = {"parent": _parent_module(parent, "ops", "loo_search"),
             "change": loo_search}
    for name, (r, n, dtype, data) in (k4_cases or K4_CASES).items():
        args, impl, _ = k4_inputs(r, n, dtype, data, dev)
        got = {}
        for side, mod in sides.items():
            trace = mod.new_trace(args[0], K4_TOL)
            x = mod.loo_search(*args, tol=K4_TOL, impl=impl, trace=trace)
            got[side] = (x, trace)
        same = all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(got["parent"], got["change"]))
        digest = hashlib.sha256(b"".join(
            t.cpu().numpy().tobytes() for t in got["change"])).hexdigest()
        print(f"k7 parent ab, K4 ({name}): "
              f"{json.dumps(dict(bitwise_equal=same, sha256=digest))}",
              flush=True)
        if not same:
            raise AssertionError(f"K4 ({name}): the shared header changed "
                                 "its outputs")
    par.initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                             backend="nccl" if dev.type == "cuda" else "gloo",
                             timeout=WORKER_TIMEOUT)
    try:
        mesh = par.make_mesh_2d((1, 1))
        for side in ("parent", "change"):
            print(f"k7 parent ab, split ({side}): "
                  f"{json.dumps(k7_split(mods[side], dev))}", flush=True)
        calls = {side: m[1].ksize_bandwidths_sharded
                 for side, m in mods.items()}
        warm = torch.as_tensor(np.random.default_rng(SEED).normal(
            size=(1000, 2)), dtype=torch.float32, device=dev)
        for fn in calls.values():
            fn(mesh, warm)
        for n in ns:
            pts = torch.as_tensor(np.random.default_rng(SEED + 18 + n).normal(
                size=(n, 2)), dtype=torch.float32, device=dev)
            row, picks = {"n": n}, {}
            for side in ("parent", "change", "change", "parent"):
                call = functools.partial(calls[side], mesh, pts)
                res, got = _peak_run(call, dev)
                if got is not None and dev.type == "cuda" and n == N_KSIZE:
                    res["event_ms"] = _cuda_ms(call)
                row.setdefault(side, []).append(res)
                if got is not None:
                    picks[side] = got
                if "oom" in res and side == "parent":
                    break                  # the same call fails again
            if len(picks) == 2:
                row["change_vs_parent_rel"] = float(
                    ((picks["change"] - picks["parent"]).abs()
                     / picks["parent"]).max())
            print(f"k7 parent ab, ksize_bandwidths_sharded N = {n}: "
                  f"{json.dumps(row)}", flush=True)
            del pts, picks
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(_card() if dev.type == "cuda" else "cpu")


K4_E2E_SETS = 6              # --k4-parent: product_batched's sets
K4_E2E_N = 1000              # ... of two 2-D beliefs of this many points
K4_E2E_REPS = 5              # products a turn


def k4_parent_ab(parent, dev=None, cases=None):
    """This checkout's K4 against ``parent``'s (``ops/loo_search.py`` of
    another checkout, e.g. an unpacked ``git archive``, loaded as a module
    of this package so that it builds the parent's ``csrc/loo_search.cu``)
    on this card.  At every phase 3f search (K4_CASES): both sides' picks
    and probe traces, bitwise equal where this checkout takes the grid
    plan, else k4_compare's limits against the twin and a count of the
    picks whose bits moved; each side timed in turns (parent, change,
    change, parent), one call between CUDA events (``_cuda_ms``) beside
    k4_bound_ms.  Then end to end, with ops/loocv.py's search on each side
    in turns: the refit seconds (host clock ending in a sync) of `*` on two
    K4_E2E_N-sample 2-D beliefs and of product_batched over K4_E2E_SETS
    sets of two, K4_E2E_REPS products a turn."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import gibbs, loo_search, loocv
    dev = dev or torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = _sm_clock_hz()
    per_pair = k4_fp64_per_pair(loo_search.build())[0]
    old = _parent_module(parent, "ops", "loo_search")
    sides = {"parent": old, "change": loo_search}
    for name, (r, n, dtype, data) in (cases or K4_CASES).items():
        args, impl, _ = k4_inputs(r, n, dtype, data, dev)
        got = {}
        for side, mod in sides.items():
            trace = mod.new_trace(args[0], K4_TOL)
            got[side] = (mod.loo_search(*args, tol=K4_TOL, impl=impl,
                                        trace=trace), trace)
        plan = loo_search.launch_plan(r, n, args[0].dtype, sms)
        same = all(torch.equal(_bits(a), _bits(b))
                   for a, b in zip(got["parent"], got["change"]))
        row = dict(case=name, rows=r, n=n, dtype=dtype, plan=plan._asdict(),
                   bitwise_equal=same, picks_moved=int(
                       (_bits(got["parent"][0]) != _bits(got["change"][0]))
                       .sum()))
        if plan.layout == "grid" and not same:
            raise AssertionError(f"K4 ({name}): the grid plan's bits moved")
        with _uncounted():
            cmp = k4_compare(args, impl, *got["change"], name)
        row.update(max_rel=cmp["max_rel"], probe_max_rel=cmp["probe_max_rel"])
        row["bound_ms"] = k4_bound_ms(args, cmp["probes"], sms, clock,
                                      per_pair)[0]
        for side in ("parent", "change", "change", "parent"):
            row.setdefault(f"{side}_ms", []).append(_cuda_ms(
                functools.partial(sides[side].loo_search, *args, tol=K4_TOL,
                                  impl=impl)))
        row["share"] = {side: row["bound_ms"] / min(row[f"{side}_ms"])
                        for side in sides}
        print(f"k4 parent ab: {json.dumps(row)}", flush=True)
        del args, got

    rng = np.random.default_rng(SEED + 19)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    bw = [1.06 * K4_E2E_N ** -0.2]
    p, q = (kt.kde(f32(rng.normal(size=(2, K4_E2E_N)) + m), bw)
            for m in (0.0, 0.5))
    sets = [[kt.kde(f32(rng.normal(size=(2, K4_E2E_N)) + 0.25 * i), bw),
             kt.kde(f32(rng.normal(size=(2, K4_E2E_N)) + 0.25 * i + 0.5),
                    bw)] for i in range(K4_E2E_SETS)]

    def star_refit():
        stages, launches = {}, {}
        _timed_product(lambda: p * q, _sync, stages, launches)
        return stages["refit"]

    def batched_refit():
        saved = gibbs.ksize_rows
        stages, launches = {}, {}
        gibbs.ksize_rows = _timed("refit", saved, _sync, stages, launches)
        try:
            kt.product_batched(sets, key=SEED)
        finally:
            gibbs.ksize_rows = saved
        return stages["refit"]
    saved = loocv.loo_search
    try:
        for what, fn in (("* refit 2x1000", star_refit),
                         (f"product_batched refit {K4_E2E_SETS}x[2x1000]",
                          batched_refit)):
            row = {"case": what}
            for side in ("parent", "change", "change", "parent"):
                loocv.loo_search = sides[side].loo_search
                fn()
                row.setdefault(f"{side}_s", []).append(float(np.median(
                    [fn() for _ in range(K4_E2E_REPS)])))
            print(f"k4 parent ab, end to end: {json.dumps(row)}", flush=True)
    finally:
        loocv.loo_search = saved
    print(_card())


K6_PARENT_ROUNDS = 2         # parent, change, change, parent: twice


def k6_parent_ab(parent, dev=None, k2_names=None, k6_cases_=None,
                 n_big=K6_BIG_N, chains=SERVE_CHAINS):
    """This checkout against ``parent`` (another checkout, e.g. an unpacked
    ``git archive``) on this card.  (1) K2: ``parent``'s
    ``ops/gibbs_select.py``, loaded as a module of this package so that it
    builds the parent's ``csrc/gibbs_select.cu`` with the parent's
    ``csrc/gibbs_logit.cuh``, against this checkout's on phase 3d's cases
    (``k2_names`` of them, default all) with phase 3d's inputs: labels and
    gathered stats bitwise equal, each side's digest printed.  (2) K6:
    ``parent``'s ``ops/sharded_select.py`` against this checkout's at
    phase 3g's timed stages (k6_inputs at 3g's seeds), one selection's
    phases summed (this checkout's with its prepare), in turns (parent,
    change, change, parent, K6_PARENT_ROUNDS times).  (3) The full-width
    replay (``chains`` chains over 2 x ``n_big``, float32, 2-D, S = 1 in a
    one-rank NCCL world, as phase 11a's _k6_full_width): ``parent``'s
    ``parallel/gibbs_kernel_sharded.py`` on the parent's K6 against this
    checkout's engine, in turns: host ms of one call ending in a sync, the
    allocator's peak over it, the chains whose labels differ."""
    import hashlib
    import torch
    import torch.distributed as dist
    import kde_tpu_torch as kt
    from kde_tpu_torch import parallel as par
    from kde_tpu_torch.ops import gibbs_select, sharded_select
    dev = dev or torch.device("cuda")
    card = dev.type == "cuda"
    sync = _sync if card else (lambda: None)
    k2p = _parent_module(parent, "ops", "gibbs_select")
    k6p = _parent_module(parent, "ops", "sharded_select")
    gksp = _parent_module(parent, "parallel", "gibbs_kernel_sharded")
    gksp._ss = k6p

    # (1) K2 bitwise
    sides = {"parent": k2p, "change": gibbs_select}
    cases = k2_cases(gibbs_select)
    for i, (name, (b, c, dn, w, d, js, dt, cov, codes, mode, ex)) in \
            enumerate(cases.items()):
        if k2_names is not None and name not in k2_names:
            continue
        args, codes, kw = k2_inputs(SEED + 20 + i, dev, b, c, dn, w, d, js,
                                    dt, cov, codes, mode, **ex)
        got = {side: mod.gibbs_select(*args, codes, **kw)
               for side, mod in sides.items()}
        sync()
        same = all(torch.equal(_bits(a) if a.is_floating_point() else a,
                               _bits(b_) if b_.is_floating_point() else b_)
                   for a, b_ in zip(got["parent"], got["change"]))
        digest = {side: hashlib.sha256(b"".join(
            t.cpu().numpy().tobytes() for t in out)).hexdigest()[:16]
                  for side, out in got.items()}
        print(f"k6 parent ab, K2 ({name}): "
              f"{json.dumps(dict(bitwise_equal=same, sha256=digest))}",
              flush=True)
        if not same:
            raise AssertionError(f"K2 ({name}): the shared header's change "
                                 "moved its outputs")
        del args, kw, got
    if card:
        print("k6 parent ab, K2 builds: " + json.dumps(
            {"parent": os.path.basename(str(k2p.build())),
             "change": os.path.basename(str(gibbs_select.build()))}),
            flush=True)

    # (2) K6's phases at the timed stages, in turns
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    all_cases = k6_cases(sms=sms)
    timed = k6_cases_ or {n: all_cases[n] for n in K6_TIMED}
    k6_seed = {n: SEED + 60 + i for i, n in enumerate(all_cases)}
    clock = _sm_clock_hz()
    for name, (c, w, d, js, dt, cov, codes, S, ex) in timed.items():
        inp = k6_inputs(k6_seed.get(name, SEED + 60), dev, dt, c, w, d, js,
                        cov, codes, S, **ex)
        with _uncounted():
            calls = {"parent": k6_phase_calls(inp, ss=k6p),
                     "change": k6_phase_calls(inp)}
            row = {"name": name, "parent_ms": [], "change_ms": []}
            for _ in range(K6_PARENT_ROUNDS):
                for side in ("parent", "change", "change", "parent"):
                    row[f"{side}_ms"].append(sum(
                        _cuda_ms(fn) for fn in calls[side].values()))
        row["bound_ms"], row["bound_by"] = k6_bound_ms(inp, sms, clock)
        for side in ("parent", "change"):
            row[f"{side}_bound_share"] = row["bound_ms"] / float(
                np.median(row[f"{side}_ms"]))
        print(f"k6 parent ab, K6 ({name}): {json.dumps(row)}", flush=True)
        del inp, calls

    # (3) the full-width replay, parent's engine against this one
    par.initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                             backend="nccl" if card else "gloo",
                             timeout=WORKER_TIMEOUT)
    try:
        mesh = par.make_mesh_2d((1, 1))
        rng = np.random.default_rng(SEED + 16)
        bw = [float(1.06 * n_big ** -0.2)]
        dens = [kt.kde((rng.normal(size=(2, n_big)) + s).astype(np.float32),
                       bw, device=dev, dtype=torch.float32)
                for s in (0.0, 0.5)]
        ru, rn = _replay_streams(np.random.default_rng(SEED + 17), chains,
                                 dens, 5)
        engines = {"parent": gksp.prod_appx_ms_gibbs_kernel_sharded,
                   "change": par.prod_appx_ms_gibbs_kernel_sharded}
        call = {side: functools.partial(fn, mesh, chains, dens, n_iter=5,
                                        rand_u=ru, rand_n=rn,
                                        record_labels=True)
                for side, fn in engines.items()}
        row, labels = {"n": n_big, "chains": chains}, {}
        for side in ("parent", "change"):            # plans, communicator
            labels[side] = call[side]()[2]
        sync()
        for _ in range(K6_PARENT_ROUNDS):
            for side in ("parent", "change", "change", "parent"):
                base = torch.cuda.memory_allocated(dev) if card else 0
                if card:
                    torch.cuda.reset_peak_memory_stats(dev)
                sync()
                t0 = time.perf_counter()
                out = call[side]()
                sync()
                row.setdefault(f"{side}_ms", []).append(
                    1e3 * (time.perf_counter() - t0))
                row.setdefault(f"{side}_peak_bytes", []).append(
                    torch.cuda.max_memory_allocated(dev) - base if card
                    else None)
                labels[side] = out[2]
                del out
        row["differing_chains"] = int((labels["parent"] != labels["change"])
                                      .any(dim=2).any(dim=1).sum())
        print(f"k6 parent ab, full-width replay 2 x {n_big}: "
              f"{json.dumps(row)}", flush=True)
    finally:
        dist.destroy_process_group()
    print(_card() if card else "cpu")


K2_PARENT_ROUNDS = 2         # parent, change, change, parent: twice
K2_PARENT_TIMED = ("leaf sweep cdf", "leaf sweep cdf uniform",
                   "leaf cond cdf", "leaf cond cdf uniform")


def _digest(tensors):
    import hashlib
    return hashlib.sha256(b"".join(t.detach().cpu().contiguous().numpy()
                                   .tobytes() for t in tensors)
                          ).hexdigest()[:16]


@contextlib.contextmanager
def _k2_of(mod):
    """Every selection of the package's stage route on ``mod``'s
    gibbs_select (another checkout's; one without ``uniform=`` is called
    without it), counted in ``mod.LAUNCHES``."""
    from kde_tpu_torch.ops import gibbs_select
    saved, fn = gibbs_select.gibbs_select, mod.gibbs_select
    takes = "uniform" in inspect.signature(fn).parameters

    def call(*args, uniform=None, **kw):
        return fn(*args, **kw, **({"uniform": uniform} if takes else {}))
    gibbs_select.gibbs_select = call
    try:
        yield
    finally:
        gibbs_select.gibbs_select = saved


def k2_parent_ab(parent, dev=None, k2_names=None, k6_names=None,
                 rounds=K2_PARENT_ROUNDS, n=N_SLICE, many=None):
    """This checkout's K2 against ``parent``'s (another checkout, e.g. an
    unpacked ``git archive``), each side's ``ops/gibbs_select.py`` loaded
    as a module of this package so that it builds its own
    ``csrc/gibbs_select.cu``.  (1) Phase 3d's gumbel cases (``k2_names``
    of them, default all): labels and gathered stats bitwise equal, each
    side's digest printed; its cdf cases: the labels that differ (a float64
    CDF tie may part them; the parent is called without ``uniform=``).
    (2) K6 at phase 3g's cases (``k6_names``, default all): every phase's
    outputs of one selection (``k6_select``) on ``parent``'s
    ``ops/sharded_select.py`` and on this checkout's, bitwise, by digests.
    (3) K2 cdf in turns (parent, change, change, parent, ``rounds``
    times; one call, CUDA events): phase 3d's leaf stages with varied and
    uniform bandwidths.  (4) In turns, host seconds ending in a sync:
    phase 10's lone circular diffop product (cdf, ``n`` chains over the
    circular pair of ``n``) and phase 10b's product of MANY_DENS densities
    (``many`` = (n, chains), default N_MANY, MANY_CHAINS), every selection
    on each side's K2, the chains whose labels differ."""
    import torch
    import kde_tpu_torch as kt
    from kde_tpu_torch import manifolds
    from kde_tpu_torch.ops import gibbs_select, sharded_select
    dev = dev or torch.device("cuda")
    card = dev.type == "cuda"
    sync = _sync if card else (lambda: None)
    k2p = _parent_module(parent, "ops", "gibbs_select")
    k6p = _parent_module(parent, "ops", "sharded_select")
    sides = {"parent": k2p, "change": gibbs_select}
    if card:
        print("k2 parent ab, builds: " + json.dumps(
            {side: os.path.basename(str(mod.build()))
             for side, mod in sides.items()}), flush=True)

    # (1) K2: gumbel bitwise, cdf labels
    cases = k2_cases(gibbs_select)
    inputs = {}
    for i, (name, (b, c, dn, w, d, js, dt, cov, codes, mode, ex)) in \
            enumerate(cases.items()):
        if k2_names is not None and name not in k2_names:
            continue
        args, codes, kw = k2_inputs(SEED + 20 + i, dev, b, c, dn, w, d, js,
                                    dt, cov, codes, mode, **ex)
        pkw = {k: v for k, v in kw.items() if k != "uniform"}
        got = {"parent": k2p.gibbs_select(*args, codes, **pkw),
               "change": gibbs_select.gibbs_select(*args, codes, **kw)}
        sync()
        row = {side: _digest(out) for side, out in got.items()}
        if mode == "gumbel":
            row["bitwise_equal"] = all(
                torch.equal(_bits(a) if a.is_floating_point() else a,
                            _bits(b_) if b_.is_floating_point() else b_)
                for a, b_ in zip(got["parent"], got["change"]))
            if not row["bitwise_equal"]:
                raise AssertionError(f"K2 gumbel ({name}): off the parent")
        else:
            row["labels_off"] = int((got["parent"][2] != got["change"][2])
                                    .sum())
            if row["labels_off"] > K2_MAX_TIES:
                raise AssertionError(f"K2 cdf ({name}): {row}")
        print(f"k2 parent ab, K2 {mode} ({name}): {json.dumps(row)}",
              flush=True)
        if name in K2_PARENT_TIMED:
            inputs[name] = (args, codes, kw, pkw)
        del got

    # (2) K6's phase outputs, bitwise
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k6_all = k6_cases(sms=sms)
    for i, (name, (c, w, d, js, dt, cov, codes, S, ex)) in \
            enumerate(k6_all.items()):
        if k6_names is not None and name not in k6_names:
            continue
        inp = k6_inputs(SEED + 60 + i, dev, dt, c, w, d, js, cov, codes, S,
                        **ex)
        with _uncounted():
            got = {side: k6_select(inp, ss=mod) for side, mod in
                   (("parent", k6p), ("change", sharded_select))}
        sync()
        flat = {side: [t for k, v in out.items() if k != "stages"
                       for t in (v if isinstance(v, list) else [v])]
                for side, out in got.items()}
        row = {side: _digest(ts) for side, ts in flat.items()}
        row["bitwise_equal"] = row["parent"] == row["change"]
        print(f"k2 parent ab, K6 ({name}): {json.dumps(row)}", flush=True)
        if not row["bitwise_equal"]:
            raise AssertionError(f"K6 ({name}): off the parent's build")
        del inp, got, flat

    # (3) K2 cdf at the leaf stages, in turns
    clock = _sm_clock_hz()
    for name, (args, codes, kw, pkw) in inputs.items():
        calls = {"parent": functools.partial(k2p.gibbs_select, *args, codes,
                                             **pkw),
                 "change": functools.partial(gibbs_select.gibbs_select,
                                             *args, codes, **kw)}
        row = {"parent_ms": [], "change_ms": []}
        for _ in range(rounds):
            for side in ("parent", "change", "change", "parent"):
                row[f"{side}_ms"].append(_cuda_ms(calls[side]))
        row["bound_ms"], row["bound_by"] = k2_bound_ms(args, codes, kw, sms,
                                                       clock)
        for side in ("parent", "change"):
            row[f"{side}_bound_share"] = row["bound_ms"] / float(
                np.median(row[f"{side}_ms"]))
        print(f"k2 parent ab, K2 cdf ({name}): {json.dumps(row)}",
              flush=True)
    del inputs

    # (4) the stage-route products, in turns
    pa, pb = _circ_pair(np.random.default_rng(SEED + 5), n, dev)
    nm, cm = many or (N_MANY, MANY_CHAINS)
    products = {
        "lone circular diffop": functools.partial(
            kt.prod_appx_ms_gibbs, n, [pa, pb], n_iter=5, key=SEED,
            select="cdf", diffop=(manifolds.circular_diff,)),
        f"{MANY_DENS} densities": functools.partial(
            kt.prod_appx_ms_gibbs, cm, _many_densities(dev, nm, MANY_DENS),
            key=SEED, select="cdf")}
    for name, call in products.items():
        row, labels = {}, {}
        for side in ("parent", "change"):            # plans, builds
            with _k2_of(sides[side]):
                labels[side] = call()[1]
        for _ in range(rounds):
            for side in ("parent", "change", "change", "parent"):
                with _k2_of(sides[side]):
                    l0 = sides[side].LAUNCHES
                    sync()
                    t0 = time.perf_counter()
                    out = call()
                    sync()
                    row.setdefault(f"{side}_s", []).append(
                        time.perf_counter() - t0)
                    row[f"{side}_launches"] = sides[side].LAUNCHES - l0
                labels[side] = out[1]
        row["differing_chains"] = int((labels["parent"] != labels["change"])
                                      .any(dim=0).sum())
        print(f"k2 parent ab, product ({name}): {json.dumps(row)}",
              flush=True)
    print(_card() if card else "cpu")


def _merged_us(spans):
    """Total microseconds covered by the ``(start, end)`` spans."""
    total, end = 0.0, -np.inf
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


K6_TRACE_CALLS = 8       # k6_trace's unprofiled calls after its warm-up


def k6_trace(tag="tree", seed=SEED, out_dir="k6_traces", n=N_SERVE,
             dev=None):
    """The kernel-sharded replay of phase 11a (SERVE_CHAINS chains over
    phase 5's 2 x N_SERVE densities, Niter 5, S = 1 in a one-rank NCCL
    world) taken apart, on the code of this checkout:

      * wall ms of one call on the host clock ending in a sync (median of
        3), and of the profiled call;
      * under torch.profiler (CPU and CUDA activity, one call after a
        warm-up), the device time in NCCL kernels, in the sharded
        selection kernel (csrc/sharded_select.cu), in every other kernel
        (eager ops) and in copies, the busy time (the union of kernel and
        copy spans) and the host gaps (wall less busy), the kernels by
        name;
      * the host ms spent inside the collectives (pmax, psum, all_gather
        of parallel/gibbs_kernel_sharded.py, wrapped) and their count,
        with and without the profiler;
      * the selection stages (calls of the engine's choose), the chain
        blocks, kernel launches and collectives a selection;
      * one more call with a sync around each selection stage: its ms
        inside the selections and outside them (the chain state).

    The unprofiled calls come first: a warm-up (which starts the NCCL
    communicator), then K6_TRACE_CALLS calls, each with its wall ms, its
    host ms inside the collectives and inside K6's wrappers (where the
    checkout has them); and the host µs of one lone pmax of a [2, 256]
    tensor (median of 200, without and with a sync after each).  Writes
    the trace to ``out_dir/k6_trace_<tag>.json.gz`` and prints one JSON
    line.  ``n`` and ``dev`` (a CPU device runs a gloo world, whose trace
    has no kernels) are for a rehearsal."""
    import gzip
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    import kde_tpu_torch as kt
    from kde_tpu_torch import parallel as par
    from kde_tpu_torch.parallel import gibbs_kernel_sharded as gks
    dev = dev or torch.device("cuda")
    sync = _sync if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(seed + 1)
    bw = [float(1.06 * n ** -0.2)]
    dens = [kt.kde((rng.normal(size=(2, n)) + s).astype(np.float32),
                   bw, device=dev, dtype=torch.float32) for s in (0.0, 0.5)]
    ru, rn = _replay_streams(np.random.default_rng(seed + 11), SERVE_CHAINS,
                             dens, 5)
    counts = {"collectives": 0, "collective_host_s": 0.0, "stages": 0,
              "stage_s": 0.0, "k6_host_s": 0.0}
    synced = [False]

    def timed_collective(fn, key="collective_host_s", n="collectives"):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            y = fn(*a, **kw)
            counts[key] += time.perf_counter() - t0
            if n:
                counts[n] += 1
            return y
        return wrapped

    def counted_choose(make):
        def maker(*a, **kw):
            choose = make(*a, **kw)

            def wrapped(stage, lvl):
                if synced[0]:
                    sync()
                t0 = time.perf_counter()
                sel = choose(stage, lvl)
                if synced[0]:
                    sync()
                counts["stage_s"] += time.perf_counter() - t0
                counts["stages"] += 1
                return sel
            return wrapped
        return maker

    saved = {k: getattr(gks, k) for k in ("pmax", "psum", "all_gather",
                                          "_sharded_choose")}
    for k in ("pmax", "psum", "all_gather"):
        setattr(gks, k, timed_collective(saved[k]))
    gks._sharded_choose = counted_choose(saved["_sharded_choose"])
    try:                                 # the parent of K6 has no wrappers
        from kde_tpu_torch.ops import sharded_select as ss
        saved_k6 = {k: getattr(ss, k) for k in K6_PHASES + ("prepare",)
                    if hasattr(ss, k)}
    except ImportError:
        ss, saved_k6 = None, {}
    for k, fn in saved_k6.items():
        setattr(ss, k, timed_collective(fn, "k6_host_s", None))
    par.initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                             backend="nccl" if dev.type == "cuda" else "gloo",
                             timeout=WORKER_TIMEOUT)
    res = {"tag": tag, "chains": SERVE_CHAINS, "n": n, "n_iter": 5}
    try:
        mesh = par.make_mesh_2d((1, 1))
        call = lambda: par.prod_appx_ms_gibbs_kernel_sharded(
            mesh, SERVE_CHAINS, dens, n_iter=5, rand_u=ru, rand_n=rn)
        call()                           # starts the NCCL communicator
        runs = {"wall_ms": [], "collective_host_ms": [], "k6_host_ms": []}
        for _ in range(K6_TRACE_CALLS):
            for k in counts:
                counts[k] = 0
            sync()
            t0 = time.perf_counter()
            call()
            sync()
            runs["wall_ms"].append(1e3 * (time.perf_counter() - t0))
            runs["collective_host_ms"].append(
                1e3 * counts["collective_host_s"])
            runs["k6_host_ms"].append(1e3 * counts["k6_host_s"])
        res["wall_ms"] = float(np.median(runs["wall_ms"]))
        res["unprofiled_runs"] = runs
        x = torch.zeros((2, SERVE_CHAINS), device=dev)
        for synced_one in (False, True):
            lone = []
            for _ in range(200):
                t0 = time.perf_counter()
                saved["pmax"](x, mesh, par.KERNELS)
                if synced_one:
                    sync()
                lone.append(1e6 * (time.perf_counter() - t0))
            key = "one_pmax_synced_us" if synced_one else "one_pmax_us"
            res[key] = float(np.median(lone))
        for k in counts:
            counts[k] = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sync()
            t0 = time.perf_counter()
            call()
            sync()
            res["profiled_wall_ms"] = 1e3 * (time.perf_counter() - t0)
        res.update(collectives=counts["collectives"],
                   collective_host_ms=1e3 * counts["collective_host_s"],
                   stages=counts["stages"])
        synced[0] = True
        counts["stage_s"] = 0.0
        sync()
        t0 = time.perf_counter()
        call()
        sync()
        wall = 1e3 * (time.perf_counter() - t0)
        res["synced_wall_ms"] = wall
        res["synced_selection_ms"] = 1e3 * counts["stage_s"]
        res["synced_chain_state_ms"] = wall - res["synced_selection_ms"]
    finally:
        for k, v in saved.items():
            setattr(gks, k, v)
        for k, v in saved_k6.items():
            setattr(ss, k, v)
        dist.destroy_process_group()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"k6_trace_{tag}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
        g.write(f.read())
    os.remove(path)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events if e.get("cat") in ("gpu_memcpy",
                                                    "gpu_memset")]
    by_name, spans = {}, []
    for e in kernels + copies:
        spans.append((e["ts"], e["ts"] + e["dur"]))
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    group = lambda n: ("nccl" if "nccl" in n.lower() else
                       "sharded_select" if "k6_" in n else "eager")
    split = {"nccl": 0.0, "sharded_select": 0.0, "eager": 0.0}
    for n, us in by_name.items():
        split[group(n)] += us
    busy = _merged_us(spans) / 1e3
    c10d = sum(e["dur"] for e in events if e.get("cat") == "cpu_op"
               and e["name"].startswith(("c10d::", "nccl:")))
    res.update(
        device_events=len(kernels),
        nccl_kernel_ms=split["nccl"] / 1e3,
        sharded_select_kernel_ms=split["sharded_select"] / 1e3,
        eager_kernel_ms=split["eager"] / 1e3,
        # a one-rank NCCL collective is a device-to-device copy, no kernel
        copy_ms=sum(e["dur"] for e in copies) / 1e3, copies=len(copies),
        device_busy_ms=busy,
        host_gap_ms=res["profiled_wall_ms"] - busy,
        c10d_host_op_ms=c10d / 1e3,
        launches=len(kernels),
        launches_per_selection=len(kernels) / max(1, res["stages"]),
        collectives_per_selection=res["collectives"] / max(1, res["stages"]),
        top_kernels_ms={n: us / 1e3 for n, us in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:15]},
        trace=os.path.relpath(path + ".gz"))
    card = _card() if dev.type == "cuda" else "cpu"
    print(f"k6 trace ({tag}) on {card}: {json.dumps(res)}", flush=True)
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: "
                         "torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from concurrent.futures import ThreadPoolExecutor
    from kde_tpu_torch import native
    from kde_tpu_torch.ops import gibbs_chain, gibbs_select, host_small
    from kde_tpu_torch.ops import (loo_search, sharded_loo, sharded_select,
                                   tiled_eval, tree_build)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = _card()
    t_start = time.perf_counter()

    # 1. device
    print(f"device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. build: the eight libraries at once, each timed from the start
    t0 = time.perf_counter()

    def timed_build(build):
        so = build()
        return so, time.perf_counter() - t0
    with ThreadPoolExecutor(8) as pool:
        jobs = [pool.submit(timed_build, b) for b in
                (tiled_eval.build, host_small.build, gibbs_select.build,
                 gibbs_chain.build, loo_search.build, sharded_select.build,
                 sharded_loo.build, tree_build.build, native.build)]
        ((k1_so, k1_s), (small_so, small_s), (k2_so, k2_s), (k3_so, k3_s),
         (k4_so, k4_s), (k6_so, k6_s), (k7_so, k7_s), (k8_so, k8_s),
         (tree_so, tree_s)) = [j.result() for j in jobs]
    ptxas = [ln.strip() for ln in tiled_eval.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {k1_s:.2f} s -> {os.path.relpath(k1_so)}; ptxas: "
          f"{ptxas[:6]}", flush=True)
    print(f"build small ops: {small_s:.2f} s -> {os.path.relpath(small_so)}; "
          f"ptxas per kernel: {json.dumps(ptxas_table(host_small.BUILD_LOG))}",
          flush=True)
    print(f"build gibbs_select: {k2_s:.2f} s -> {os.path.relpath(k2_so)}; "
          f"ptxas per kernel: "
          f"{json.dumps(ptxas_table(gibbs_select.BUILD_LOG))}", flush=True)
    print(f"build gibbs_chain: {k3_s:.2f} s -> {os.path.relpath(k3_so)}; "
          f"ptxas per kernel: "
          f"{json.dumps(ptxas_table(gibbs_chain.BUILD_LOG))}", flush=True)
    print(f"build loo_search: {k4_s:.2f} s -> {os.path.relpath(k4_so)}; "
          f"ptxas per kernel: "
          f"{json.dumps(ptxas_table(loo_search.BUILD_LOG))}", flush=True)
    print(f"build sharded_select: {k6_s:.2f} s -> {os.path.relpath(k6_so)}; "
          f"ptxas per kernel: "
          f"{json.dumps(ptxas_table(sharded_select.BUILD_LOG))}", flush=True)
    print(f"build sharded_loo: {k7_s:.2f} s -> {os.path.relpath(k7_so)}; "
          f"ptxas per kernel: "
          f"{json.dumps(ptxas_table(sharded_loo.BUILD_LOG))}", flush=True)
    print(f"build tree_build: {k8_s:.2f} s -> {os.path.relpath(k8_so)}; "
          f"ptxas per kernel: "
          f"{json.dumps(ptxas_table(tree_build.BUILD_LOG))}", flush=True)
    print(f"build native ball tree (g++ {' '.join(native.CXX_FLAGS)}): "
          f"{tree_s:.2f} s -> {os.path.relpath(tree_so)}", flush=True)

    # 3. kernel vs plain twin; 3b. the small-route kernels; 3d. the Gibbs
    # selection kernel; 3e. the Gibbs chain kernel; 3f. the LOOCV search;
    # 3g. the kernel-sharded selection; 3h. the sharded LOOCV search; 3i.
    # the device plan's tree
    rows, worst = phase_kernel(dev)
    small_rows, small_worst = phase_small(dev)
    k2_rows = phase_gibbs_select(dev)
    k3_rows = phase_gibbs_chain(dev)
    k4_rows = phase_loo_search(dev)
    k6_rows = phase_sharded_select(dev)
    k7_rows = phase_sharded_loo(dev)
    k8_rows = phase_tree_build(dev)

    # 3c-12. the main paths; only their launches count, each path's read
    # just after it ran (and the native tree builds, likewise)
    runs, builds, small, k2, k3, k4, k6, k6_twin, k7, k7_twin, k8 = (
        {} for _ in range(11))
    k4_rows_plan = {}

    def run(name, fn, *args):
        tiled_eval.LAUNCHES = native.BUILDS = gibbs_select.LAUNCHES = 0
        gibbs_chain.LAUNCHES = loo_search.LAUNCHES = 0
        loo_search.ROWS_LAUNCHES = 0
        sharded_select.LAUNCHES = sharded_select.TWIN_STAGES = 0
        sharded_loo.LAUNCHES = sharded_loo.TWIN_STAGES = 0
        tree_build.LAUNCHES = 0
        host_small.LAUNCHES.update(dict.fromkeys(host_small.LAUNCHES, 0))
        out = fn(*args)
        runs[name], builds[name] = tiled_eval.LAUNCHES, native.BUILDS
        small[name] = dict(host_small.LAUNCHES)
        k2[name], k3[name] = gibbs_select.LAUNCHES, gibbs_chain.LAUNCHES
        k4[name] = loo_search.LAUNCHES
        k4_rows_plan[name] = loo_search.ROWS_LAUNCHES
        k6[name] = sharded_select.LAUNCHES
        k6_twin[name] = sharded_select.TWIN_STAGES
        k7[name], k7_twin[name] = sharded_loo.LAUNCHES, sharded_loo.TWIN_STAGES
        k8[name] = tree_build.LAUNCHES
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
    md = run("many_densities", phase_many_densities, dev)
    print(f"{MANY_DENS}-density product of {N_MANY} 2-D points, "
          f"{MANY_CHAINS} chains on {card}: {json.dumps(md)}", flush=True)
    pl = run("parallel", phase_parallel, dev, p, q, serve)
    print(f"parallel 11a, one NCCL rank, on {card}: {json.dumps(pl)}",
          flush=True)
    sc = phase_shared_card()
    # counted in the two worker processes, around the sharded calls only
    runs["shared_card"] = sum(r["log_eval_launches"] + r["loo_launches"]
                              for r in sc)
    k6["shared_card"] = sum(r["k6_launches"] for r in sc)
    k6_twin["shared_card"] = sum(r["k6_twin_stages"] for r in sc)
    k7["shared_card"] = sum(r["k7_launches"] for r in sc)
    k7_twin["shared_card"] = sum(r["k7_twin_stages"] for r in sc)
    if sc[0]["ksize_bandwidths"] != sc[1]["ksize_bandwidths"]:
        raise AssertionError(f"ksize_bandwidths_sharded S = 2: the ranks "
                             f"differ: {sc[0]['ksize_bandwidths']}, "
                             f"{sc[1]['ksize_bandwidths']}")
    print(f"parallel 11b, two gloo ranks sharing the card, on {card}: "
          f"{json.dumps(sc)}", flush=True)
    run("examples", phase_examples, dev)
    tl = run("tools", phase_tools, dev)
    print(f"tools_torch phase 13 on {card}: "
          f"{sum(v['seconds'] for v in tl.values()):.1f} s", flush=True)
    for name in ("slice", "functionals", "parallel", "shared_card"):
        if runs[name] < 1:
            raise AssertionError(f"path {name} never launched the kernel")
    for name in ("slice", "device_plan", "batched", "functionals",
                 "manifolds", "parallel"):
        if k4[name] < 1:
            raise AssertionError(f"path {name} never launched loo_search")
    for name in ("slice", "serve", "device_plan", "batched", "select",
                 "manifolds", "parallel", "examples", "tools"):
        if k3[name] < 1:
            raise AssertionError(f"path {name} never launched gibbs_chain")
    if k2["manifolds"] < 1:
        raise AssertionError("the lone circular diffop never launched "
                             "gibbs_select")
    if k2["many_densities"] < 1 or k3["many_densities"] != 0:
        raise AssertionError(f"the {MANY_DENS}-density product: "
                             f"{k2['many_densities']} gibbs_select and "
                             f"{k3['many_densities']} gibbs_chain launches")
    for name in ("parallel", "shared_card"):
        if k6[name] < 1 or k6_twin[name] != 0:
            raise AssertionError(f"path {name}: {k6[name]} sharded_select "
                                 f"launches, {k6_twin[name]} selection "
                                 "stages on its twins")
    if any(k6[name] for name in k6 if name not in ("parallel",
                                                   "shared_card")):
        raise AssertionError(f"sharded_select launched off the sharded "
                             f"paths: {k6}")
    for name in ("parallel", "shared_card"):
        if k7[name] < 1 or k7_twin[name] != 0:
            raise AssertionError(f"path {name}: {k7[name]} sharded_loo "
                                 f"launches, {k7_twin[name]} phases on its "
                                 "twins")
    if any(k7[name] for name in k7 if name not in ("parallel",
                                                   "shared_card")):
        raise AssertionError(f"sharded_loo launched off the sharded paths: "
                             f"{k7}")
    for name in ("device_plan", "batched"):
        if k8[name] < 1:
            raise AssertionError(f"path {name} never launched tree_build")
    for name in ("select", "tools"):
        if k2[name] != 0:
            raise AssertionError(f"path {name} launched gibbs_select "
                                 f"{k2[name]} times: gumbel belongs to "
                                 "gibbs_chain")
    main_launches = sum(runs.values())
    small_launches = {k: sum(r[k] for r in small.values())
                      for k in host_small.LAUNCHES}
    print(f"kernel launches per path: {json.dumps(runs)}", flush=True)
    print(f"small-route kernel launches per path: {json.dumps(small)}",
          flush=True)
    print(f"native tree builds per path: {json.dumps(builds)}", flush=True)
    print(f"gibbs_select launches per path: {json.dumps(k2)}", flush=True)
    print(f"gibbs_chain launches per path: {json.dumps(k3)}", flush=True)
    print(f"loo_search launches per path: {json.dumps(k4)}; on the rows "
          f"plan: {json.dumps(k4_rows_plan)}", flush=True)
    print(f"sharded_select launches per path: {json.dumps(k6)}; twin "
          f"stages: {json.dumps(k6_twin)}", flush=True)
    print(f"sharded_loo launches per path: {json.dumps(k7)}; twin "
          f"phases: {json.dumps(k7_twin)}", flush=True)
    print(f"tree_build launches per path: {json.dumps(k8)}", flush=True)
    print(f"whole script on {card}: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    golden, ev = small_rows["loo_golden cfg1"], small_rows[
        "small_log_eval cfg1"]
    leaf = k2_rows["leaf sweep cdf"]
    chain, chain_serve = k3_rows["keyed f32 slice"], k3_rows["keyed f32 serve"]
    gumbel_rows = {name.split()[-1]: k3_rows[name] for name in K3_GUMBEL_TIMED}
    refit = k4_rows["* refit"]
    sweep = k6_rows["leaf sweep"]
    k7_main = k7_rows[K7_MAIN]
    k8_main = k8_rows[f"2x{N_SLICE} d2"]
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
        "dense_ms": rows["a"]["dense_ms"],
        "diag_max_abs_err": max(r["max_abs_err"] for r in rows["g"].values()),
        "sharded_loo_launches": sum(
            [pl["launches"][k] for k in ("sharded_loo_entropy",
                                         "sharded_loo_entropy_numpy",
                                         "sharded_loo_entropy_full_width")]
            + [r["loo_launches"] for r in sc]),
        "sharded_loo_100k_ms": pl["loo_full_width"]["cuda_ms"],
        "sharded_loo_100k_peak_bytes": pl["loo_full_width"]["peak_bytes"]}, {
        "name": "loo_golden", "route": "cuda",
        "entry": "ksize_small: bracket and golden search, one launch",
        "source": "kde_tpu_torch/csrc/small_ops.cu",
        "replaces": "kde_tpu/native/hostops.cpp:260",
        "launches": small_launches["loo_golden"],
        "max_abs_err": small_worst["loo_golden"], "ms": golden["ms"],
        "plain_ms": golden["plain_ms"], "bound_ms": golden["bound_ms"],
        "bound_by": golden["bound_by"], "library_ms": None,
        "cluster": golden["cluster"], "ms_c1": golden["ms_c1"],
        "ms_inner20": golden["ms_inner20"],
        "device_ms": golden["device_ms"],
        "device_ms_c1": golden["device_ms_c1"],
        "search_ms": golden["search_ms"],
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
        "ms_inner20": ev["ms_inner20"], "device_ms": ev["device_ms"],
        "parent_f32_ms": ev["parent_f32_ms"],
        "empty_ms": ev["empty_ms"],
        "empty_device_ms": ev["empty_device_ms"]}, {
        "name": "gibbs_select", "route": "cuda",
        "source": "kde_tpu_torch/csrc/gibbs_select.cu",
        "replaces": "kde_tpu/ops/gibbs.py:267 (_kernel_logits_raw, "
                    "_dead_predicate, _apply_dead_fallback, _select_label "
                    "or _select_label_gumbel, select_stats; XLA-fused)",
        "design": "cdf redesigned: tiles of rows sharing each staged "
                  "chunk of the level, log c once a row on uniform levels, "
                  "the CDF scan in one chunk",
        "layout": leaf["plan"]["layout"],
        "ms_uniform": k2_rows["leaf sweep cdf uniform"]["ms"],
        "bound_ms_uniform": k2_rows["leaf sweep cdf uniform"]["bound_ms"],
        "ms_cond": k2_rows["leaf cond cdf"]["ms"],
        "ms_cond_uniform": k2_rows["leaf cond cdf uniform"]["ms"],
        "many_densities_gibbs_s": md["gibbs_s"],
        "launches": sum(k2.values()),
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows.values()),
        "label_mismatches": sum(r["label_mismatches"]
                                for r in k2_rows.values()),
        "max_cdf_tie": max([t for r in k2_rows.values()
                            for t in r["cdf_ties"]] or [0.0]),
        "ms": leaf["ms"], "plain_ms": leaf["plain_ms"],
        "bound_ms": leaf["bound_ms"], "bound_by": leaf["bound_by"],
        "bound_share": leaf["bound_share"], "library_ms": None,
        "multinomial_ms_for_scale": leaf["multinomial_ms_for_scale"],
        "ms_inner20": leaf["ms_inner20"],
        "ms_gumbel": k2_rows["leaf sweep gumbel"]["ms"],
        "bound_ms_gumbel": k2_rows["leaf sweep gumbel"]["bound_ms"],
        "plain_ms_gumbel": k2_rows["leaf sweep gumbel"]["plain_ms"]}, {
        "name": "gibbs_chain", "route": "cuda",
        "source": "kde_tpu_torch/csrc/gibbs_chain.cu",
        "replaces": "kde_tpu/ops/gibbs.py:498 (_run_chain; XLA-fused, the "
                    "chain has no Pallas kernel)",
        "launches": sum(k3.values()),
        "max_abs_err": max(r["max_abs_err"] for r in k3_rows.values()),
        "same_share_min": min(r["same_share"] for r in k3_rows.values()),
        "differing_chains": sum(len(r["differing"])
                                for r in k3_rows.values()),
        "max_tie_gap": max([c["tie_gap"] for r in k3_rows.values()
                            for c in r["differing"]] or [0.0]),
        "ms": chain["ms"], "plain_ms": chain["plain_ms"],
        "bound_ms": chain["bound_ms"], "bound_by": chain["bound_by"],
        "bound_share": chain["bound_share"], "library_ms": None,
        "ms_serve": chain_serve["ms"], "plain_ms_serve":
        chain_serve["plain_ms"], "bound_ms_serve": chain_serve["bound_ms"],
        "bound_share_serve": chain_serve["bound_share"],
        **{f"{k}_{name}": k3_rows[name][k] for name in K3_TIMED
           for k in ("ms", "plain_ms", "bound_ms", "bound_share")},
        **{f"{k}_gumbel_{name}": row[k] for name, row in gumbel_rows.items()
           for k in ("ms", "plain_ms", "bound_ms", "bound_share")}}, {
        "name": "loo_search", "route": "cuda",
        "source": "kde_tpu_torch/csrc/loo_search.cu",
        "replaces": "kde_tpu/ops/loocv.py:273 (_ksize_search; its Pallas "
                    "probe kde_tpu/ops/kernels.py:269)",
        "launches": sum(k4.values()),
        "launches_rows_plan": sum(k4_rows_plan.values()),
        "max_abs_err": max(r["max_abs_err"] for r in k4_rows.values()),
        "f64_max_rel": max(r["max_rel"] for r in k4_rows.values()
                           if r["dtype"] == "float64"),
        "probe_max_rel": max(r["probe_max_rel"] for r in k4_rows.values()),
        "ms": refit["ms"], "plain_ms": refit["plain_ms"],
        "bound_ms": refit["bound_ms"], "bound_by": refit["bound_by"],
        "bound_share": refit["bound_share"], "library_ms": None,
        "parent_ms": refit["parent_ms"],
        "ksize_rows_ms": refit["ksize_rows_ms"],
        **{f"{k}_{name}": k4_rows[name][k] for name in k4_rows
           for k in ("ms", "plain_ms", "parent_ms", "bound_ms",
                     "bound_share")}}, {
        "name": "sharded_select", "route": "cuda",
        "source": "kde_tpu_torch/csrc/sharded_select.cu",
        "replaces": "kde_tpu/parallel/gibbs_kernel_sharded.py:158 "
                    "(_select_sharded) and the local work of :190-283 "
                    "(_run_chain_ks); XLA-fused in the shard_map program",
        "launches": sum(k6.values()),
        "max_abs_err": max(r["max_abs_err"] for r in k6_rows.values()),
        "index_mismatches": sum(r["index_mismatches"]
                                for r in k6_rows.values()),
        "max_cdf_tie": max([t for r in k6_rows.values()
                            for t in r["cdf_ties"]] or [0.0]),
        "ms": sweep["ms"], "plain_ms": sweep["plain_ms"],
        "bound_ms": sweep["bound_ms"], "bound_by": sweep["bound_by"],
        "bound_share": sweep["bound_share"], "library_ms": None,
        "design": "redesigned: row tiles x candidate chunks staged in shared "
                  "memory by cp.async, log c once a row on uniform levels, "
                  "count_below from per-chunk sums; prepared once a stage",
        **{f"{k}_{name}": k6_rows[name][k] for name in K6_TIMED
           for k in ("ms", "raw_ms", "plain_ms", "bound_ms",
                     "bound_share")}}, {
        "name": "sharded_loo", "route": "cuda",
        "source": "kde_tpu_torch/csrc/sharded_loo.cu",
        "replaces": "kde_tpu/parallel/eval.py:151-191 (the probe of "
                    "ksize_bandwidths_sharded and its golden loop, "
                    "kde_tpu/ops/loocv.py:180; XLA-fused in the shard_map "
                    "program, no Pallas kernel)",
        "launches": sum(k7.values()),
        "max_abs_err": max(r["max_abs_err"] for r in k7_rows.values()
                           if "max_abs_err" in r),
        "phase_max_rel": max(v for r in k7_rows.values()
                             for v in r["phase_max_rel"].values()),
        "ms": k7_main["ms"], "plain_ms": k7_main["plain_ms"],
        "bound_ms": k7_main["bound_ms"], "bound_by": k7_main["bound_by"],
        "bound_share": k7_main["bound_share"], "library_ms": None,
        "design": "redesigned: the queries split over the whole mesh with "
                  "every column on each rank; one launch a sweep (the golden "
                  "step before it in its head, the entropies in its tail) "
                  "and one all-reduce",
        "sweeps": pl["ksize"]["sweeps"],
        "collectives": pl["ksize"]["collectives"],
        "host_waits": pl["ksize"]["host_waits"],
        **{f"{k}_{name.replace(' ', '_')}": k7_rows[name][k]
           for name in K7_CASES for k in ("ms", "bound_ms", "bound_share")
           if name in k7_rows}}, {
        "name": "tree_build", "route": "cuda",
        "source": "kde_tpu_torch/csrc/tree_build.cu",
        "replaces": "kde_tpu/ops/device_plan.py:140-210 (device_tree_stats "
                    "and the plan's assembly; XLA-fused jnp on the TPU, no "
                    "Pallas kernel)",
        "design": "a block a slice of at most one block's shared memory: "
                  "every depth below it (bitonic sorts, then rank counts), "
                  "its moments and slots in one launch; a multi-block route "
                  "a depth at a time above that width; the level arrays in "
                  "one more launch",
        "launches": sum(k8.values()), "max_abs_err": 0.0,
        "ms": k8_main["ms"], "plain_ms": k8_main["plain_ms"],
        "bound_ms": k8_main["bound_ms"], "bound_by": k8_main["bound_by"],
        "bound_share": k8_main["bound_share"], "library_ms": None,
        **{f"{k}_{name.replace(' ', '_')}": row[k]
           for name, row in k8_rows.items()
           for k in ("ms", "ms_inner20", "plain_ms", "bound_ms",
                     "plan_host_ms", "twin_plan_host_ms", "plan_launches",
                     "twin_plan_launches")}}]}))
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
    elif sys.argv[1:2] == ["--small-parent"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        small_parent_ab(sys.argv[2])
    elif sys.argv[1:2] == ["--k2-diag"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        k2_diag()
    elif sys.argv[1:2] == ["--k3-parent"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        k3_parent_ab(sys.argv[2])
    elif sys.argv[1:2] == ["--k7-parent"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        k7_parent_ab(sys.argv[2])
    elif sys.argv[1:2] == ["--k7-split"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        k7_split_main(sys.argv[2])
    elif sys.argv[1:2] == ["--k6-parent"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        k6_parent_ab(sys.argv[2])
    elif sys.argv[1:2] == ["--k2-parent"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        k2_parent_ab(sys.argv[2])
    elif sys.argv[1:2] == ["--k4-parent"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        k4_parent_ab(sys.argv[2])
    elif sys.argv[1:2] == ["--k4-diag"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        k4_diag()
    elif sys.argv[1:2] == ["--k8"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        k8_main()
    elif sys.argv[1:2] == ["--k8-routes"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        k8_routes()
    elif sys.argv[1:2] == ["--k3-diag"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        k3_diag()
    elif sys.argv[1:2] == ["--k6-trace"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        k6_trace(*sys.argv[2:3], **({"out_dir": sys.argv[3]}
                                    if len(sys.argv) > 3 else {}))
    else:
        main()
