"""Routing gates of the port (ports ``kde_tpu/config.py:21-33, 70-109,
131-141``).

The size gates are the JAX package's: they are routing semantics (which path
a given problem size takes), so the two packages route alike and the tests
compare like with like.  They were tuned for a TPU and are still to be
re-measured on the H100.  The label-selection thresholds were measured on
the H100.  Tests monkeypatch all of them as module attributes.
"""

import logging

import torch

_log = logging.getLogger("kde_tpu_torch")

# Where NumPy, string and file inputs go when the caller names no device:
# the card, as the JAX package puts them on its default device.  Without a
# card such a call raises torch's own CUDA error; nothing falls back to the
# CPU.  Tests set "cpu".  Tensor inputs keep their own device.
DEVICE: str = "cuda"

# The reference's FORCE_EVAL_DIRECT (src/KernelDensityEstimate.jl:54): its
# evaluation is always direct (exact) here; the flag is kept for API
# compatibility and read by nothing.
FORCE_EVAL_DIRECT: bool = True

# Above this many query*component pairs, evaluation stops materializing the
# [M, N] logit matrix: float32 Euclidean densities take the tiled route
# (ops/tiled_eval.py), everything else chunks the query axis.
DIRECT_PAIR_LIMIT: int = 1 << 24

# Above this many N*N pairs per dimension, the LOOCV entropy stops
# materializing the [d, N, N] logits and takes the tiled route (float32) or
# query chunks (float64); see ops/loocv.py::select_loo_impl.
LOOCV_PAIR_LIMIT: int = 1 << 28

# Query-block size of the chunked LOO entropy path.
LOOCV_CHUNK: int = 1024

# Label selection of the KEYED Gibbs path (ops/gibbs.py::resolve_select):
# "cdf" (flat inverse CDF, the replay path's arithmetic), "blocked" (the
# same draw block by block, no full-width prefix sum), "gumbel"
# (argmax of logits plus Gumbel noise), or "size": route each problem by
# the thresholds below.  Replay mode always draws with "cdf".
GIBBS_SELECT: str = "size"

# "size" thresholds, set from the H100 readings of chip_smoke.py phase 8
# (PERF.md §6, table "PR 2 select cells"; NVIDIA H100 80GB HBM3, 700 W):
# cdf won the bench headline (B = 6 x [2 x 1000], 1000 chains) and B = 8;
# gumbel won 2 x 50,000 at 256 chains and the 2 x 20,000 `*` Gibbs stage
# (20,000 chains); blocked won no cell, so no problem routes to it.  Four
# cells leave the split points coarse: the crossovers between them are not
# measured (ROADMAP keeps the full M10 grid open).
SELECT_BLOCKED_WIDTH: int = 1 << 30   # blocked: leaf width...
SELECT_BLOCKED_MAX_CHAINS: int = 0    # ...and chains
SELECT_GUMBEL_WIDTH: int = 50000      # gumbel: leaf width where it won...
SELECT_GUMBEL_BATCH: int = 1 << 30    # ...no set count where it won...
SELECT_GUMBEL_WORK: int = 1 << 22     # ...or chains x width (cdf won 1e6)

# The small-problem routes (ops/host_small.py), at the JAX package's values
# and names (kde_tpu/config.py:122-129) so that a test sets both packages'
# gates side by side.  They are routing semantics: at or below a gate the op
# computes in float64 on the density's device (the CUDA kernels of
# csrc/small_ops.cu on the card, their plain twins on the CPU) and returns
# float64 tensors, whatever the density's dtype.  They engage only for
# densities built from NumPy (host copies present) with NumPy queries and
# int or None keys; 0 pins an op to the density-dtype route.  They must
# equal kde_tpu's values, which decide which calls return float64 there:
# they are parity settings, not speed thresholds for this card, and are not
# to be re-tuned for speed (the card's crossover above them is not
# measured).  On the card the LOOCV route takes N <= host_small.GOLDEN_MAX_N.
HOST_LOOCV_LIMIT: int = 1 << 16   # LOOCV: N * N * d (N = 256 at d = 1)
HOST_EVAL_LIMIT: int = 1 << 18    # evaluation: M * N * d
HOST_SAMPLE_LIMIT: int = 1 << 18  # sampling: n * (N + n) * d


def default_device(device=None) -> torch.device:
    """``device``, or :data:`DEVICE` when it is ``None``."""
    return torch.device(DEVICE if device is None else device)


def input_device(x) -> torch.device:
    """Where the work on input ``x`` runs: a tensor's own device, and
    :data:`DEVICE` for anything else (NumPy arrays, lists)."""
    return x.device if isinstance(x, torch.Tensor) else default_device()


def set_force_eval_direct(flag: bool = False) -> None:
    """API-compatible setter (reference ``setForceEvalDirect!``,
    src/KernelDensityEstimate.jl:56-60).  Evaluation is exact here, so
    turning direct evaluation off changes nothing but this flag."""
    global FORCE_EVAL_DIRECT
    FORCE_EVAL_DIRECT = bool(flag)
    if not flag:
        _log.info("kde_tpu_torch evaluates densities exactly; dual-tree "
                  "pruning does not exist here and err_tol is accepted for "
                  "compatibility only.")
