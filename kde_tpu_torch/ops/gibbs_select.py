"""One selection step of the Gibbs chain in one launch (the port's K2; on
the TPU this is part of the XLA-fused ``kde_tpu/ops/gibbs.py::_run_chain``:
``_kernel_logits_raw`` :267-282, ``_dead_predicate`` :290-308,
``_apply_dead_fallback`` :311-319, ``_select_label`` :335-354 or
``_select_label_gumbel`` :400-414, and ``select_stats`` :557-564).

For every row (set b, chain c, density j of ``js``) of a level,
:func:`gibbs_select` scores the level's candidates against the Gaussian of
mean ``mu[b, c]`` and covariance ``bw + cov[b, c]``, applies the degenerate
fallback, draws the label (``cdf`` from the stage's uniforms ``u``, or
``gumbel`` from counter noise drawn inside the kernel from the sets' seeds,
the global chain index and the selection id, csrc/counter_rng.cuh) and
gathers the winner's mean, variance and label.  CUDA tensors launch the
hand-written kernel ``csrc/gibbs_select.cu`` (its candidate logit is
``csrc/gibbs_logit.cuh``, shared with the kernel-sharded selection,
``ops/sharded_select.py``); CPU tensors take the plain twin
:func:`gibbs_select_ref`, the eager ops of ``ops/gibbs.py``.  The library
is built with nvcc (``--fmad=false``) into ``_build/`` at the first launch;
a failed build, a refused launch or an input the kernel does not take
raises, and nothing falls back.  :func:`launch_plan` picks the kernel's
layout from the launch's shape before the launch: a warp a row for
narrow levels, a block a row for wide ones, and for ``cdf`` over wide
levels with many rows tiles of rows that share each chunk of the level
staged in shared memory.

Per-dimension differences are coded: 0 Euclidean, 1
``manifolds.circular_diff``.  Any other ``diffop`` is a user's Python
callable, which no kernel runs: :func:`diff_codes` gives None for it, and
the local engine then takes its eager twin by design (``TWIN_STAGES``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import manifolds
from .tiled_eval import nvcc_build

# Launches of the kernel; a run sets it to 0 and reads it to show the path
# went through the kernel.
LAUNCHES = 0
# Selection stages the local engine ran on its eager twin because no kernel
# runs them (``select="blocked"``, a user's diffop), counted on any device.
TWIN_STAGES = 0

# The kernel's layouts: a warp a row (8 rows a block) up to this width, one
# 512-thread block a row above it; the row's logits stay in shared memory
# where they take at most CACHE_MAX_BYTES (float32 at w = 50,000 does),
# and are recomputed in each pass otherwise.
WARP_MAX_WIDTH = 1024
CTA_THREADS = 512
WARP_ROWS = 8
CACHE_MAX_BYTES = 200 * 1024
# cdf's tile layout (csrc/gibbs_select.cu's constants where named so): a
# block of TILE_ROWS rows, a warp each, streams the level through a ring
# of STAGES slots of about SLOT_BYTES of means, log weights and bandwidths
# (a multiple of 32 candidates; the slot also holds the bandwidths' logs,
# which a stage without cov takes once a block); the CDF search cuts the
# level into at most MAX_CHUNKS chunks of whole slots.
# Launches of at least TILE_MIN_ROWS rows over levels wider than
# WARP_MAX_WIDTH take it; fewer rows fill the card better a row a block
# (on an H100 the tiles lose or draw below 4,096 rows at widths
# 1,536-20,000 and win from 4,096 at every width up to 50,000).
TILE_ROWS = 16           # kTileThreads / 32
TILE_MIN_ROWS = 4096
STAGES = 3               # kStages
SLOT_BYTES = 10240
MAX_CHUNKS = 64          # kMaxChunks
SMEM_MAX_BYTES = 226 * 1024   # kMaxSmem
LAYOUTS = ("warp", "block", "tiles")   # the C entry's layout codes 0, 1, 2

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "gibbs_select.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# log(1e-99): the reference's degenerate-likelihood threshold
# (src/MSGibbs01.jl:311); ops/gibbs.py::_LOG_DEAD
LOG_DEAD = float(np.log(1e-99))

_lib = None
BUILD_LOG = ""
_CPU = torch.device("cpu")
_FLOATS = (torch.float32, torch.float64)


def build() -> Path:
    """Compile ``csrc/gibbs_select.cu`` (once per source and flags) and
    return the shared library's path; a failed build raises."""
    global BUILD_LOG
    out, log = nvcc_build(SOURCE, NVCC_FLAGS, "gibbs_select")
    BUILD_LOG = log or BUILD_LOG
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_double)
        lib.kde_gibbs_select.argtypes = ([i] * 7 + [vp] * 4 + [ll] * 4
                                         + [vp] * 7 + [ll] * 2 + [vp] * 3
                                         + [i] * 7 + [f] * 3 + [vp])
        lib.kde_gibbs_select.restype = i
        _lib = lib
    return _lib


def diff_codes(diffop, d: int) -> Optional[Tuple[int, ...]]:
    """The kernel's per-dimension difference codes of a normalized
    ``diffop`` tuple (None: all Euclidean): 0 for ``euclid_diff``, 1 for
    ``circular_diff``; None when any dimension carries another callable."""
    if diffop is None:
        return (0,) * d
    codes = []
    for op in diffop:
        if op is manifolds.euclid_diff:
            codes.append(0)
        elif op is manifolds.circular_diff:
            codes.append(1)
        else:
            return None
    return tuple(codes)


def diffop_of(codes: Sequence[int]) -> Optional[tuple]:
    """The per-dim ``diffop`` tuple of ``codes`` (None when all are 0),
    the inverse of :func:`diff_codes`."""
    if not any(codes):
        return None
    return tuple(manifolds.circular_diff if k else manifolds.euclid_diff
                 for k in codes)


class Plan(NamedTuple):
    """One launch's layout: ``layout`` (a name of LAYOUTS), ``group``
    threads a row, whether the rows' logits stay in shared memory
    (``cache``), the block's dynamic shared memory in bytes (``smem``),
    ``rows`` a block and, on tiles, the CDF search's ``chunks`` chunks of
    ``chunk`` candidates and the ring's ``slot`` candidates a slot (the
    warp and block layouts: one chunk of the level, no ring)."""
    layout: str
    group: int
    cache: bool
    smem: int
    rows: int
    chunk: int
    chunks: int
    slot: int


def _tile_plan(w: int, d: int, itemsize: int, rows: int) -> Optional[Plan]:
    """The tile layout of ``rows`` rows over ``w`` candidates
    (csrc/gibbs_select.cu's ``tile_smem``), with fewer rows where a
    block's shared memory cannot hold it; None where one row cannot."""
    per = (2 * d + 1) * itemsize
    slot = max(32, SLOT_BYTES // per // 32 * 32)
    slots = -(-w // slot)
    chunk = -(-slots // MAX_CHUNKS) * slot
    chunks = -(-w // chunk)
    head = 4 * d * itemsize + d if not 1 <= d <= 3 else 0
    ring = STAGES * slot * (3 * d + 1) * itemsize    # with the logs of bw
    while rows >= 1:
        smem = rows * (chunks * 8 + head) + ring
        if smem <= SMEM_MAX_BYTES:
            return Plan("tiles", 32, False, smem, rows, chunk, chunks, slot)
        rows //= 2
    return None


def launch_plan(w: int, d: int, itemsize: int, rows: int = 0,
                gumbel: bool = False, layout: Optional[str] = None) -> Plan:
    """The :class:`Plan` of ``rows`` rows over a level of ``w`` candidates
    in ``d`` dims of ``itemsize`` bytes.  By shape (``layout`` None): cdf
    over a level wider than WARP_MAX_WIDTH with at least TILE_MIN_ROWS
    rows takes ``tiles`` (TILE_ROWS rows of a warp a block); otherwise
    a warp a row up to WARP_MAX_WIDTH (the logits cached where 8 rows'
    fit) and a ``CTA_THREADS``-thread block a row above, the logits cached
    where ``(w + 4d) itemsize + d`` fits CACHE_MAX_BYTES (shared memory:
    per row mu, cov, c and log c, the cache, then d flag bytes).
    ``layout`` forces one.  Pure Python: the CPU tests check it."""
    if layout is None:
        layout = "warp" if w <= WARP_MAX_WIDTH else "block"
        if not gumbel and w > WARP_MAX_WIDTH and rows >= TILE_MIN_ROWS:
            layout = "tiles"
    if layout not in LAYOUTS or (layout == "tiles" and gumbel):
        raise ValueError(f"gibbs_select: no {layout} layout"
                         + (" for gumbel" if gumbel else ""))
    if layout == "tiles":
        plan = _tile_plan(w, d, itemsize, TILE_ROWS)
        if plan is not None:
            return plan
        layout = "block"             # d too large for a ring slot
    if layout == "warp":
        group, n = 32, WARP_ROWS
        cache = n * ((4 * d + w) * itemsize + d) <= SMEM_MAX_BYTES
    else:
        group, n = CTA_THREADS, 1
        cache = (w + 4 * d) * itemsize + d <= CACHE_MAX_BYTES
    smem = n * ((4 * d + (w if cache else 0)) * itemsize + d)
    return Plan(layout, group, cache, smem, n, w, 1, 0)


def _check(lvl_mean, lvl_bw, lvl_logw, lvl_perm, js, mu, cov, active, codes,
           u, seeds, chain0, sel0, uniform=None):
    """Shapes and the one device of the inputs; returns ``js`` as a tuple
    and the device.  Raises on anything else."""
    js = tuple(int(j) for j in js)
    b, dn, w, d = lvl_mean.shape
    c = mu.shape[1] if mu.dim() == 3 else -1
    n_js = len(js)
    want = {"lvl_bw": (lvl_bw, (b, dn, w, d)),
            "lvl_logw": (lvl_logw, (b, dn, w)),
            "lvl_perm": (lvl_perm, (b, dn, w)),
            "mu": (mu, (b, c, d)), "active": (active, (b, dn, d))}
    if cov is not None:
        want["cov"] = (cov, (b, c, d))
    if uniform is not None:
        want["uniform"] = (uniform, (b, dn, d))
    if (u is None) == (seeds is None):
        raise ValueError("gibbs_select takes exactly one of u (cdf) and "
                         "seeds (gumbel)")
    if u is not None:
        want["u"] = (u, (b, c, n_js))
    else:
        want["seeds"] = (seeds, (b, 2))
    bad = [f"{k} {tuple(t.shape)} (want {s})" for k, (t, s) in want.items()
           if tuple(t.shape) != s]
    if (bad or c < 0 or w < 1 or d < 1 or not js
            or js != tuple(range(js[0], js[0] + n_js))
            or js[0] < 0 or js[-1] >= dn or not 0 <= chain0
            or chain0 + c > 1 << 32 or not 0 <= sel0 <= (1 << 32) - n_js):
        raise ValueError(f"gibbs_select: level [B, dn, w, d] = "
                         f"{tuple(lvl_mean.shape)}, js {js}, chains from "
                         f"{chain0}, selections from {sel0}; {bad}")
    if codes is None or len(codes) != d or any(k not in (0, 1) for k in codes):
        raise ValueError(f"gibbs_select: codes must be d = {d} of 0/1, got "
                         f"{codes}")
    tensors = [t for t, _ in want.values()] + [lvl_mean]
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type not in ("cpu", "cuda"):
        raise ValueError("gibbs_select: inputs must all lie on the CPU or on "
                         f"one CUDA device, got {sorted(map(str, devs))}")
    floats = [lvl_mean, lvl_bw, lvl_logw, mu] + [t for t in (cov, u)
                                                 if t is not None]
    dts = {t.dtype for t in floats}
    if (len(dts) != 1 or dts.pop() not in _FLOATS
            or lvl_perm.dtype != torch.int64 or active.dtype != torch.bool
            or (seeds is not None and seeds.dtype != torch.int64)
            or (uniform is not None
                and uniform.dtype not in (torch.bool, torch.uint8))):
        raise TypeError("gibbs_select: float32 or float64 level, mu, cov "
                        "and u of one dtype, int64 lvl_perm and seeds, bool "
                        "active and bool or uint8 uniform; got "
                        f"{[t.dtype for t in floats]}, {lvl_perm.dtype}, "
                        f"{active.dtype}"
                        + ("" if uniform is None else f", {uniform.dtype}"))
    return js, next(iter(devs))


def gibbs_select(lvl_mean: torch.Tensor, lvl_bw: torch.Tensor,
                 lvl_logw: torch.Tensor, lvl_perm: torch.Tensor,
                 js: Sequence[int], mu: torch.Tensor,
                 cov: Optional[torch.Tensor], active: torch.Tensor,
                 codes: Sequence[int], u: Optional[torch.Tensor] = None,
                 seeds: Optional[torch.Tensor] = None, chain0: int = 0,
                 sel0: int = 0, uniform: Optional[torch.Tensor] = None):
    """One selection step of the densities ``js`` (a contiguous range) at
    one level.

    ``lvl_mean``/``lvl_bw`` ``[B, dn, w, d]``, ``lvl_logw``/``lvl_perm``
    ``[B, dn, w]`` (``plans.level(l)``; a ``[w, d]`` slab contiguous per set
    and density); ``mu`` and ``cov`` (or None) ``[B, C, d]``; ``active
    [B, dn, d]`` bool; ``codes`` per dim (:func:`diff_codes`); either the
    uniforms ``u [B, C, |js|]`` (the inverse-CDF draw) or, for the
    Gumbel-max draw, the sets' counter seeds ``seeds [B, 2]`` (int64), the
    global index ``chain0`` of chain 0 and the selection id ``sel0`` of
    ``js[0]`` (``js[jj]``'s is ``sel0 + jj``): the kernel draws the noise
    of ``ops/gibbs.py::_gumbel_noise`` itself.  ``uniform [B, dn, d]``
    (bool or uint8; None: every dim varied) flags the dims where every
    candidate of the level has the same bandwidth (``lvl_uniform`` of the
    plan, ``gibbs_chain.level_uniform``): cdf then takes ``c`` and ``log
    c`` once a row there, the same values; gumbel and the twin ignore it.
    Returns the winners' ``(mean, var [B, C, |js|, d], label [B, C,
    |js|])``, the labels taken from ``lvl_perm``."""
    global LAUNCHES
    js, dev = _check(lvl_mean, lvl_bw, lvl_logw, lvl_perm, js, mu, cov,
                     active, codes, u, seeds, chain0, sel0, uniform)
    if dev == _CPU:
        return gibbs_select_ref(lvl_mean, lvl_bw, lvl_logw, lvl_perm, js, mu,
                                cov, active, codes, u, seeds, chain0, sel0)
    b, _, w, d = lvl_mean.shape
    plan = launch_plan(w, d, lvl_mean.element_size(),
                       rows=b * mu.shape[1] * len(js),
                       gumbel=seeds is not None)
    out = _launch(_load(), plan, lvl_mean, lvl_bw, lvl_logw, lvl_perm, js, mu,
                  cov, active, codes, u, seeds, chain0, sel0, uniform)
    if b * mu.shape[1]:
        LAUNCHES += 1
    return out


def _launch(lib, plan: Plan, lvl_mean, lvl_bw, lvl_logw, lvl_perm, js, mu,
            cov, active, codes, u, seeds, chain0, sel0, uniform):
    """One launch of ``lib``'s ``kde_gibbs_select`` with ``plan``'s layout
    on checked CUDA inputs (uncounted), into fresh outputs; a refused
    launch raises."""
    b, dn, w, d = lvl_mean.shape
    c, n_js, dev = mu.shape[1], len(js), mu.device
    if (lvl_mean.stride()[2:] != (d, 1) or lvl_bw.stride() != lvl_mean.stride()
            or lvl_logw.stride(2) != 1
            or lvl_perm.stride() != lvl_logw.stride()):
        raise ValueError("gibbs_select: each (set, density) slab of the level "
                         "must be contiguous, lvl_bw laid out as lvl_mean and "
                         "lvl_perm as lvl_logw")
    mu, active = mu.contiguous(), active.contiguous()
    cov = None if cov is None else cov.contiguous()
    u = None if u is None else u.contiguous()
    seeds = None if seeds is None else seeds.contiguous()
    uniform = None if uniform is None or u is None else uniform.contiguous()
    out_mean = torch.empty((b, c, n_js, d), dtype=mu.dtype, device=dev)
    out_var = torch.empty_like(out_mean)
    out_label = torch.empty((b, c, n_js), dtype=torch.int64, device=dev)
    two_pi, inv_two_pi = _two_pi(mu.dtype)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        rc = lib.kde_gibbs_select(
            lvl_mean.element_size(), int(seeds is not None),
            LAYOUTS.index(plan.layout), int(plan.cache), plan.rows,
            plan.chunk, plan.slot,
            lvl_mean.data_ptr(), lvl_bw.data_ptr(), lvl_logw.data_ptr(),
            lvl_perm.data_ptr(), lvl_mean.stride(0), lvl_mean.stride(1),
            lvl_logw.stride(0), lvl_logw.stride(1), mu.data_ptr(), ptr(cov),
            active.data_ptr(), _codes_on(tuple(codes), dev).data_ptr(),
            ptr(uniform), ptr(u), ptr(seeds), chain0, sel0,
            out_mean.data_ptr(), out_var.data_ptr(), out_label.data_ptr(),
            b, c, n_js, js[0], dn, w, d, two_pi, inv_two_pi, LOG_DEAD,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"kde_gibbs_select launch failed: CUDA error {rc} "
                           f"({plan.layout} layout)")
    return out_mean, out_var, out_label


@functools.lru_cache(maxsize=64)
def _codes_on(codes: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``codes`` as a uint8 tensor on ``device``, uploaded once."""
    return torch.as_tensor(codes, dtype=torch.uint8, device=device)


@functools.lru_cache(maxsize=None)
def _two_pi(dtype) -> Tuple[float, float]:
    """2 pi and its reciprocal as torch forms them for ``d / (2 pi)`` and
    ``2 pi * r`` with a Python scalar on the card: the scalar rounded to
    the tensor's dtype, the division a product with ``1 / scalar`` taken
    in that dtype."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    tp = np_dt(2.0 * math.pi)
    return float(tp), float(np_dt(1.0) / tp)


def gibbs_select_ref(lvl_mean: torch.Tensor, lvl_bw: torch.Tensor,
                     lvl_logw: torch.Tensor, lvl_perm: torch.Tensor,
                     js: Sequence[int], mu: torch.Tensor,
                     cov: Optional[torch.Tensor], active: torch.Tensor,
                     codes: Sequence[int], u: Optional[torch.Tensor] = None,
                     seeds: Optional[torch.Tensor] = None, chain0: int = 0,
                     sel0: int = 0, uniform: Optional[torch.Tensor] = None):
    """Plain twin of :func:`gibbs_select`, on any device: the eager ops of
    ``ops/gibbs.py`` (``_kernel_logits_raw``, ``_dead_predicate``,
    ``_apply_dead_fallback``, then ``_select_label`` on ``u`` or
    ``_select_label_gumbel`` on the counter noise, and the gather) density
    by density; ``uniform`` is ignored (every bandwidth is read)."""
    from . import gibbs as _g       # ops/gibbs.py imports this module
    js = tuple(int(j) for j in js)
    stage = _g._Stage(js, mu, cov, u, active, active.cpu().numpy(),
                      diffop_of(codes))

    def draw(jj, logits):
        if seeds is not None:           # one density's noise at a time
            return _g._select_label_gumbel(seeds, logits, chain0, sel0 + jj)
        return _g._select_label(u[:, :, jj], logits)
    return _g._select_eager(stage, (lvl_mean, lvl_bw, lvl_logw, lvl_perm),
                            draw)
