"""The local work of one kernel-sharded Gibbs selection, between its
collectives (the port's K6; on the TPU this is part of the XLA-fused
``shard_map`` program of ``kde_tpu/parallel/gibbs_kernel_sharded.py``:
``_select_sharded`` :158-187 and the one-hot stats of ``_run_chain_ks``
:190-283).

``parallel/gibbs_kernel_sharded.py`` runs a selection as six phases
around six collectives, in the JAX package's order::

    m     = local_max(rows)                        -> pmax: m0
    s     = shifted_sum(rows, m0)                  -> psum: ssum
    dead, mfb = dead_max(m0, ssum, m, real)        -> pmax: gmax
    e     = exp_sum(rows, gmax, dead)              -> all_gather: tots
    n     = count_below(rows, gmax, dead, tots, sid, u)  -> psum: z
    stats = owner_stats(stats, js, z, n_shards, sid)     -> psum

where ``rows`` (:class:`Rows`) holds this shard's level slice and the
stage's densities ``js``, chains and hooks.  One call covers every density
of the stage and every chain of the block, and no phase keeps a
``[|js|, C, w]`` tensor on the card: the kernels recompute the logits in
each pass.  CUDA tensors launch the hand-written kernels of
``csrc/sharded_select.cu`` (built with nvcc ``--fmad=false`` into
``_build/`` at the first launch; the candidate logit is
``csrc/gibbs_logit.cuh``, K2's); CPU tensors take each entry's plain twin
``*_ref``, the eager ops of ``ops/gibbs.py``, with the same signature.  A
failed build, a refused launch or an input the kernel does not take
raises; nothing falls back.  A user's own ``diffop``, which no kernel
runs, raises here on the card: the engine sends it to the twins by design
and counts each such stage in ``TWIN_STAGES``.

The twin of ``shifted_sum`` makes the kernel's one cut: a row whose global
max reaches log(1e-99) gives 1, not its sum.  The global sum holds
exp(0) = 1 and no negative term, so such a row is live either way: the
degenerate test, and so every label, is the JAX package's.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .gibbs_select import _codes_on, _two_pi, diff_codes
from .tiled_eval import nvcc_build

# Launches of the kernels; a run sets it to 0 and reads it to show the path
# went through them.
LAUNCHES = 0
# Selection stages the kernel-sharded engine ran on the twins (CPU tensors,
# a user's diffop), counted on any device.
TWIN_STAGES = 0

# A row on one warp (8 rows a block) up to this width, on one 512-thread
# block above it.
WARP_MAX_WIDTH = 1024
CTA_THREADS = 512
SMEM_MAX_BYTES = 48 * 1024

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "sharded_select.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# log(1e-99): the reference's degenerate-likelihood threshold
# (src/MSGibbs01.jl:311); ops/gibbs.py::_LOG_DEAD
LOG_DEAD = float(np.log(1e-99))
# the row kernels' phases (csrc/sharded_select.cu)
_MAX, _SUM, _ESUM, _COUNT = range(4)

_lib = None
BUILD_LOG = ""
_FLOATS = (torch.float32, torch.float64)


class Rows(NamedTuple):
    """The rows of one sharded selection: this shard's level slice
    ``mean``/``bw`` ``[dn, w, d]`` and ``logw [dn, w]`` (each density's
    ``[w, d]`` slab contiguous), the stage's densities ``js`` (a contiguous
    range), the chains' ``mu [C, d]`` and ``cov [C, d]`` (or None), the
    active dims ``active [dn, d]`` and the normalized ``diffop`` tuple
    (None: Euclidean).  A row is ``(js[jj], c)``; results are ``[|js|,
    C]``."""
    mean: torch.Tensor
    bw: torch.Tensor
    logw: torch.Tensor
    js: Tuple[int, ...]
    mu: torch.Tensor
    cov: Optional[torch.Tensor]
    active: torch.Tensor
    diffop: Optional[tuple]


def build() -> Path:
    """Compile ``csrc/sharded_select.cu`` (once per source, its headers and
    the flags) and return the shared library's path; a failed build
    raises."""
    global BUILD_LOG
    out, log = nvcc_build(SOURCE, NVCC_FLAGS, "sharded_select")
    BUILD_LOG = log or BUILD_LOG
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_double)
        lib.kde_k6_rows.argtypes = ([i] * 3 + [vp] * 3 + [ll] * 2 + [vp] * 9
                                    + [ll] * 2 + [vp] + [i] * 8 + [f] * 3
                                    + [vp])
        lib.kde_k6_dead_max.argtypes = ([i] + [vp] * 4 + [i] * 2 + [f]
                                        + [vp] * 3)
        lib.kde_k6_owner_stats.argtypes = ([vp] * 2 + [ll] + [i] * 8
                                           + [vp] * 2)
        for fn in (lib.kde_k6_rows, lib.kde_k6_dead_max,
                   lib.kde_k6_owner_stats):
            fn.restype = i
        _lib = lib
    return _lib


def group_of(w: int) -> int:
    """Threads a row: a warp up to ``WARP_MAX_WIDTH`` candidates, a
    ``CTA_THREADS`` block above."""
    return 32 if w <= WARP_MAX_WIDTH else CTA_THREADS


def _device(tensors) -> torch.device:
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1 or next(iter(devs)).type not in ("cpu", "cuda"):
        raise ValueError("sharded_select: inputs must all lie on the CPU or "
                         f"on one CUDA device, got {sorted(map(str, devs))}")
    return devs.pop()


def _check(rows: Rows, *extra) -> Tuple[torch.device, Optional[tuple]]:
    """Shapes, dtypes and the one device of ``rows`` and the phase's other
    inputs ``extra`` (tensors or None); returns the device and the
    kernel's difference codes (None for a user's diffop)."""
    mean, bw, logw, js, mu, cov, active, diffop = rows
    if mean.dim() != 3 or mu.dim() != 2:
        raise ValueError(f"sharded_select: mean [dn, w, d] and mu [C, d], "
                         f"got {tuple(mean.shape)}, {tuple(mu.shape)}")
    dn, w, d = mean.shape
    c = mu.shape[0]
    want = {"bw": (bw, (dn, w, d)), "logw": (logw, (dn, w)),
            "mu": (mu, (c, d)), "active": (active, (dn, d))}
    if cov is not None:
        want["cov"] = (cov, (c, d))
    bad = [f"{k} {tuple(t.shape)} (want {s})" for k, (t, s) in want.items()
           if tuple(t.shape) != s]
    js = tuple(js)
    if (bad or w < 1 or d < 1 or not js
            or js != tuple(range(js[0], js[0] + len(js)))
            or js[0] < 0 or js[-1] >= dn):
        raise ValueError(f"sharded_select: level [dn, w, d] = "
                         f"{tuple(mean.shape)}, js {js}; {bad}")
    dev = _device([mean, bw, logw, mu, cov, active, *extra])
    dts = {t.dtype for t in (mean, bw, logw, mu, cov) if t is not None}
    if (len(dts) != 1 or next(iter(dts)) not in _FLOATS
            or active.dtype != torch.bool):
        raise TypeError("sharded_select: float32 or float64 mean, bw, logw, "
                        "mu and cov of one dtype and bool active; got "
                        f"{sorted(map(str, dts))}, {active.dtype}")
    return dev, diff_codes(diffop, d)


def _launch_rows(phase, rows, out, codes, m0=None, gmax=None, dead=None,
                 tots=None, sid=0, u=None):
    global LAUNCHES
    mean, bw, logw, js, mu, cov, active, _ = rows
    dn, w, d = mean.shape
    if codes is None:
        raise ValueError("sharded_select: a user's diffop runs on the twins "
                         "(*_ref), not on the card's kernels")
    if (mean.stride()[1:] != (d, 1) or bw.stride() != mean.stride()
            or logw.stride(1) != 1):
        raise ValueError("sharded_select: each density's slab of the level "
                         "must be contiguous, bw laid out as mean")
    item = mean.element_size()
    if 8 * (2 * d * item + d) > SMEM_MAX_BYTES:
        raise ValueError(f"sharded_select: d = {d} is more than the "
                         "kernel's shared memory holds")
    mu, active = mu.contiguous(), active.contiguous()
    cov = None if cov is None else cov.contiguous()
    dev = mean.device
    two_pi, inv_two_pi = _two_pi(mean.dtype)
    ptr = lambda t: None if t is None else t.data_ptr()
    n_shards = 1 if tots is None else tots.shape[0]
    u_c, u_j = (0, 0) if u is None else u.stride()
    with torch.cuda.device(dev):
        rc = _load().kde_k6_rows(
            phase, item, group_of(w), mean.data_ptr(), bw.data_ptr(),
            logw.data_ptr(), mean.stride(0), logw.stride(0), mu.data_ptr(),
            ptr(cov), active.data_ptr(), _codes_on(codes, dev).data_ptr(),
            ptr(m0), ptr(gmax), ptr(dead), ptr(tots), ptr(u), u_c, u_j,
            out.data_ptr(), mu.shape[0], len(js), js[0], dn, w, d, n_shards,
            sid, two_pi, inv_two_pi, LOG_DEAD,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"kde_k6_rows (phase {phase}) launch failed: "
                           f"CUDA error {rc}")
    if out.numel():
        LAUNCHES += 1
    return out


def _row_input(x, rows: Rows, dtype, what):
    """A ``[|js|, C]`` input of a row phase, checked and contiguous."""
    want = (len(rows.js), rows.mu.shape[0])
    if tuple(x.shape) != want or x.dtype != dtype:
        raise ValueError(f"sharded_select: {what} must be {want} {dtype}, "
                         f"got {tuple(x.shape)} {x.dtype}")
    return x.contiguous()


def _rows_out(rows: Rows, dtype):
    return torch.empty((len(rows.js), rows.mu.shape[0]), dtype=dtype,
                       device=rows.mean.device)


# ---------------------------------------------------------------------------
# the kernel entries; each takes its twin on CPU tensors
# ---------------------------------------------------------------------------

def local_max(rows: Rows) -> torch.Tensor:
    """``[|js|, C]``: the largest raw logit of each row on this shard."""
    dev, codes = _check(rows)
    if dev.type == "cpu":
        return local_max_ref(rows)
    return _launch_rows(_MAX, rows, _rows_out(rows, rows.mean.dtype), codes)


def shifted_sum(rows: Rows, m0: torch.Tensor) -> torch.Tensor:
    """``[|js|, C]``: ``sum(exp(l - ms0))`` in the chain's dtype, ``ms0``
    the global max ``m0`` (0 where it is -inf); 1 where ``m0`` reaches
    log(1e-99) (the module's note)."""
    dev, codes = _check(rows, m0)
    m0 = _row_input(m0, rows, rows.mean.dtype, "m0")
    if dev.type == "cpu":
        return shifted_sum_ref(rows, m0)
    return _launch_rows(_SUM, rows, _rows_out(rows, rows.mean.dtype), codes,
                        m0=m0)


def exp_sum(rows: Rows, gmax: torch.Tensor,
            dead: torch.Tensor) -> torch.Tensor:
    """``[|js|, C]`` float64: ``sum(exp(l' - gmax))``, ``l'`` the logits
    after the degenerate fallback of the ``dead`` rows, the exps in the
    chain's dtype."""
    dev, codes = _check(rows, gmax, dead)
    gmax = _row_input(gmax, rows, rows.mean.dtype, "gmax")
    dead = _row_input(dead, rows, torch.bool, "dead")
    if dev.type == "cpu":
        return exp_sum_ref(rows, gmax, dead)
    return _launch_rows(_ESUM, rows, _rows_out(rows, torch.float64), codes,
                        gmax=gmax, dead=dead)


def count_below(rows: Rows, gmax: torch.Tensor, dead: torch.Tensor,
                tots: torch.Tensor, sid: int, u: torch.Tensor) -> torch.Tensor:
    """``[|js|, C]`` int64: the count of this shard's CDF entries
    ``(offset + local cumsum) / total`` below ``u [C, |js|]`` (any
    strides), in float64; ``tots [S, |js|, C]`` every shard's
    :func:`exp_sum` in shard order, ``offset`` the sum of those before
    shard ``sid``, ``total`` of all."""
    dev, codes = _check(rows, gmax, dead, tots, u)
    gmax = _row_input(gmax, rows, rows.mean.dtype, "gmax")
    dead = _row_input(dead, rows, torch.bool, "dead")
    n_js, c = len(rows.js), rows.mu.shape[0]
    if (tots.dim() != 3 or tuple(tots.shape[1:]) != (n_js, c)
            or tots.dtype != torch.float64 or not 0 <= sid < tots.shape[0]
            or tuple(u.shape) != (c, n_js) or u.dtype != rows.mean.dtype):
        raise ValueError(f"sharded_select: tots [S, {n_js}, {c}] float64, "
                         f"0 <= sid < S and u [{c}, {n_js}] of the chain's "
                         f"dtype; got {tuple(tots.shape)} {tots.dtype}, sid "
                         f"{sid}, {tuple(u.shape)} {u.dtype}")
    if dev.type == "cpu":
        return count_below_ref(rows, gmax, dead, tots, sid, u)
    return _launch_rows(_COUNT, rows, _rows_out(rows, torch.int64), codes,
                        gmax=gmax, dead=dead, tots=tots.contiguous(),
                        sid=sid, u=u)


def dead_max(m0: torch.Tensor, ssum: torch.Tensor, m: torch.Tensor,
             real: torch.Tensor):
    """The degenerate test of ``[|js|, C]`` rows from the global max
    ``m0`` and shifted sum ``ssum``, and the local max ``m`` of the rows as
    the fallback leaves them: ``(dead, mfb)``; ``real [|js|]``: whether
    this shard holds a real candidate of each density."""
    global LAUNCHES
    dev = _device([m0, ssum, m, real])
    shape = tuple(m.shape)
    if (len(shape) != 2 or tuple(m0.shape) != shape
            or tuple(ssum.shape) != shape or tuple(real.shape) != shape[:1]
            or m.dtype not in _FLOATS or m0.dtype != m.dtype
            or ssum.dtype != m.dtype or real.dtype != torch.bool):
        raise ValueError(f"sharded_select: m0, ssum, m [J, C] of one float "
                         f"dtype and real [J] bool; got {tuple(m0.shape)}, "
                         f"{tuple(ssum.shape)}, {shape}, {tuple(real.shape)}")
    if dev.type == "cpu":
        return dead_max_ref(m0, ssum, m, real)
    m0, ssum, m, real = (t.contiguous() for t in (m0, ssum, m, real))
    dead = torch.empty(shape, dtype=torch.bool, device=dev)
    mfb = torch.empty_like(m)
    with torch.cuda.device(dev):
        rc = _load().kde_k6_dead_max(
            m.element_size(), m0.data_ptr(), ssum.data_ptr(), m.data_ptr(),
            real.data_ptr(), shape[0], shape[1], LOG_DEAD, dead.data_ptr(),
            mfb.data_ptr(), torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"kde_k6_dead_max launch failed: CUDA error {rc}")
    if m.numel():
        LAUNCHES += 1
    return dead, mfb


def owner_stats(stats: torch.Tensor, js: Sequence[int], z: torch.Tensor,
                n_shards: int, sid: int) -> torch.Tensor:
    """``[|js|, C, F]`` float64: for each row, this shard's ``stats [dn,
    w, F]`` row at the global index ``z [|js|, C]`` (clamped into ``[0,
    n_shards * w - 1]``) where the shard owns it, zeros where it does
    not."""
    global LAUNCHES
    js = tuple(js)
    dev = _device([stats, z])
    if (stats.dim() != 3 or stats.dtype != torch.float64
            or z.dim() != 2 or z.shape[0] != len(js) or z.dtype != torch.int64
            or not js or js != tuple(range(js[0], js[0] + len(js)))
            or js[0] < 0 or js[-1] >= stats.shape[0]
            or not 0 <= sid < n_shards):
        raise ValueError(f"sharded_select: stats [dn, w, F] float64, z "
                         f"[{len(js)}, C] int64, js a range and 0 <= sid < "
                         f"S; got {tuple(stats.shape)} {stats.dtype}, "
                         f"{tuple(z.shape)} {z.dtype}, js {js}, sid {sid}, "
                         f"S {n_shards}")
    if dev.type == "cpu":
        return owner_stats_ref(stats, js, z, n_shards, sid)
    dn, w, f = stats.shape
    if stats.stride()[1:] != (f, 1):
        raise ValueError("sharded_select: each stats row must be contiguous")
    z = z.contiguous()
    out = torch.empty(tuple(z.shape) + (f,), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = _load().kde_k6_owner_stats(
            z.data_ptr(), stats.data_ptr(), stats.stride(0), js[0], len(js),
            z.shape[1], dn, w, f, n_shards, sid, out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"kde_k6_owner_stats launch failed: CUDA error "
                           f"{rc}")
    if out.numel():
        LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# the plain twins: the eager ops of ops/gibbs.py, on any device
# ---------------------------------------------------------------------------

def _logits(rows: Rows) -> torch.Tensor:
    """The raw logits ``[|js|, C, w]`` (``ops/gibbs.py::
    _kernel_logits_raw``, density by density)."""
    from . import gibbs as _g       # ops/gibbs.py imports this module
    act_host = rows.active.cpu().numpy()
    cov = None if rows.cov is None else rows.cov[None]
    return torch.cat([_g._kernel_logits_raw(
        rows.mean[None, j], rows.bw[None, j], rows.logw[None, j],
        rows.mu[None], cov, (rows.active[None, j], act_host[None, j]),
        rows.diffop) for j in rows.js])


def _fallback_logits(rows: Rows, dead: torch.Tensor) -> torch.Tensor:
    """The logits after the degenerate fallback of the ``dead`` rows
    (``ops/gibbs.py::_apply_dead_fallback``)."""
    from . import gibbs as _g
    js = rows.js
    return _g._apply_dead_fallback(_logits(rows),
                                   rows.logw[js[0]:js[-1] + 1], dead)


def local_max_ref(rows: Rows) -> torch.Tensor:
    """Plain twin of :func:`local_max`."""
    return _logits(rows).max(dim=-1).values


def shifted_sum_ref(rows: Rows, m0: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`shifted_sum`."""
    ms0 = torch.where(torch.isneginf(m0), torch.zeros_like(m0), m0)
    s = torch.exp(_logits(rows) - ms0[..., None]).sum(dim=-1)
    return torch.where(m0 >= LOG_DEAD, torch.ones_like(s), s)


def dead_max_ref(m0: torch.Tensor, ssum: torch.Tensor, m: torch.Tensor,
                 real: torch.Tensor):
    """Plain twin of :func:`dead_max`."""
    ms0 = torch.where(torch.isneginf(m0), torch.zeros_like(m0), m0)
    dead = ms0 + torch.log(ssum) < LOG_DEAD
    fb = torch.where(real[:, None], torch.zeros_like(m),
                     torch.full_like(m, -math.inf))
    return dead, torch.where(dead, fb, m)


def exp_sum_ref(rows: Rows, gmax: torch.Tensor,
                dead: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`exp_sum`."""
    e = torch.exp(_fallback_logits(rows, dead) - gmax[..., None])
    return e.to(torch.float64).sum(dim=-1)


def count_below_ref(rows: Rows, gmax: torch.Tensor, dead: torch.Tensor,
                    tots: torch.Tensor, sid: int,
                    u: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`count_below`: (offset + cumsum) / total, the
    JAX package's association."""
    e = torch.exp(_fallback_logits(rows, dead) - gmax[..., None]
                  ).to(torch.float64)
    total = tots.sum(dim=0)
    offset = tots[:sid].sum(dim=0)
    cdf = (offset[..., None] + torch.cumsum(e, dim=-1)) / total[..., None]
    return (cdf < u.T[..., None].to(torch.float64)).sum(dim=-1)


def owner_stats_ref(stats: torch.Tensor, js: Sequence[int], z: torch.Tensor,
                    n_shards: int, sid: int) -> torch.Tensor:
    """Plain twin of :func:`owner_stats`."""
    js = tuple(js)
    w = stats.shape[1]
    z_loc = z.clamp(0, n_shards * w - 1) - sid * w
    owner = (z_loc >= 0) & (z_loc < w)
    b = torch.arange(len(js), device=stats.device)[:, None]
    picked = stats[js[0]:js[-1] + 1][b, z_loc.clamp(0, w - 1)]
    return torch.where(owner[..., None], picked, 0.0)
