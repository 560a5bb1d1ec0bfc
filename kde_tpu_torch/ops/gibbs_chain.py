"""The whole Gibbs chain in one launch (the port's K3, with the selection
step K2 of ``ops/gibbs_select.py`` as its inner step; on the TPU the chain
is the XLA-fused ``kde_tpu/ops/gibbs.py::_run_chain``, :498-651).

:func:`gibbs_chain` runs every chain of ``B`` density sets from the roots to
the final draw for ``select = "cdf"`` (from the uniform stream) and
``select = "gumbel"`` (from counter noise drawn in the kernel, a pure
function of the set's seed, the chain, the selection id and the candidate;
csrc/counter_rng.cuh): per level the point draw, the conditioning
selection of every density and ``n_iter`` leave-one-out sweeps, with no
host step between stages.  CUDA tensors launch the
hand-written kernel ``csrc/gibbs_chain.cu`` once; CPU tensors take the
plain twin :func:`gibbs_chain_ref`, the eager ``ops/gibbs.py::_run_chain``
with ``gibbs_select_ref`` as its selection.  The library is built with nvcc
(``--fmad=false``) into ``_build/`` at the first launch; a failed build, a
refused launch or an input the kernel does not take raises, and nothing
falls back.

Manifold hooks are coded per dimension (:func:`hook_codes`): 0 for the
Euclidean quadruple, 1 for the circular one of ``manifolds.py``.  Any
other callable is a user's, which no kernel runs: the codes are then None
and ``ops/gibbs.py::_route`` keeps such a product off this route.

:func:`launch_plan` picks the kernel's layout from the set's shape: float32
chains at d <= 3 in sets of 1,024 chains and more over wide levels (the
slice, the batched product, the device plan, the manifolds) take the
staged layout, chains of a set in lockstep sharing candidate tiles staged
in shared memory; float64 chains (the replay paths), d >= 4, narrow
levels (the bench headline, ``scaling_bench``) and a few hundred chains
over wide levels (serve) take the warp or block layout.  That is a route
by shape: each layout raises on a refused launch like the other.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from .. import manifolds
from . import gibbs_select as _gs
from .tiled_eval import nvcc_build

# Launches of the kernel; a run sets it to 0 and reads it to show the path
# went through the kernel.
LAUNCHES = 0

# The kernel's layouts, by what measured faster on the H100 (chip_smoke.py
# --k3-diag, PERF.md §6).  Float32 chains at d <= STAGED_MAX_DIM in a set
# of at least STAGED_MIN_CHAINS chains whose widest level has at least
# STAGED_MIN_WIDTH candidates take the staged layout: 16 chains of one set
# a block, in lockstep, the candidates staged in shared memory.  Everything
# else (float64, d > STAGED_MAX_DIM, narrow levels, fewer chains) takes the
# first layouts: a warp a chain (8 chains a block) when a set has at least
# WARP_MIN_CHAINS chains or its widest level at most WARP_MAX_WIDTH
# candidates, one CTA_THREADS-thread block a chain otherwise.  Every
# choice reads the set's shape alone, so a set drawn in a batch runs as it
# does alone.
STAGED_MAX_DIM = 3
STAGED_MIN_WIDTH = 4096
STAGED_MIN_CHAINS = 1024
STAGED_CHAINS = 16
WARP_MIN_CHAINS = 1024
WARP_MAX_WIDTH = 2048
CTA_THREADS = 512
LAYOUTS = {"warp": 0, "block": 1, "staged": 2}


# csrc/gibbs_chain.cu's kMaxDens and kMaxDim
MAX_DENS = 16
MAX_DIM = 16

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "gibbs_chain.cu"
NVCC_FLAGS = _gs.NVCC_FLAGS

_lib = None
BUILD_LOG = ""
_CPU = torch.device("cpu")

_EUCLID = (manifolds.euclid_add, manifolds.euclid_diff, manifolds.euclid_mu,
           manifolds.euclid_lambda)
_CIRCULAR = (manifolds.circular_add, manifolds.circular_diff,
             manifolds.circular_mu, manifolds.circular_lambda)


def build() -> Path:
    """Compile ``csrc/gibbs_chain.cu`` (once per source and flags) and
    return the shared library's path; a failed build raises."""
    global BUILD_LOG
    out, log = nvcc_build(SOURCE, NVCC_FLAGS, "gibbs_chain")
    BUILD_LOG = log or BUILD_LOG
    return out


def bind(path) -> ctypes.CDLL:
    """The library at ``path`` with ``kde_gibbs_chain``'s signature set."""
    lib = ctypes.CDLL(str(path))
    vp, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_double)
    lib.kde_gibbs_chain.argtypes = (
        [i] * 3 + [vp] * 2 + [ll] * 2 + [vp] * 4 + [ll] * 4 + [vp] * 5
        + [ll] * 2 + [vp] * 2 + [ll] * 2 + [vp] * 2 + [i] * 7 + [f] * 3
        + [vp])
    lib.kde_gibbs_chain.restype = i
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


def hook_codes(hooks, d: int) -> Optional[Tuple[int, ...]]:
    """The kernel's per-dimension codes of a normalized hook quadruple
    ``(addop, diffop, get_mu, get_lambda)`` (``ops/gibbs.py::
    normalize_hooks``; None entries are Euclidean): 0 where all four are
    the Euclidean defaults, 1 where all four are ``manifolds``' circular
    hooks; None when any dimension carries anything else."""
    per_dim = [h if h is not None else (e,) * d
               for h, e in zip(hooks or (None,) * 4, _EUCLID)]
    codes = []
    for k in range(d):
        ops = tuple(h[k] for h in per_dim)
        if ops == _EUCLID:
            codes.append(0)
        elif ops == _CIRCULAR:
            codes.append(1)
        else:
            return None
    return tuple(codes)


def hooks_of(codes: Sequence[int]):
    """The normalized hook quadruple of ``codes``, the inverse of
    :func:`hook_codes` (all None when every code is 0)."""
    if not any(codes):
        return (None,) * 4
    return tuple(tuple(_CIRCULAR[i] if k else _EUCLID[i] for k in codes)
                 for i in range(4))


def level_uniform(lvl_bw: torch.Tensor, offsets) -> torch.Tensor:
    """``uint8 [..., dn, L, d]``: 1 where every node of level ``l`` has the
    same bandwidth in that dim, so the kernel takes ``log c`` once a
    selection (padded slots repeat a real node, so they never break it).
    ``lvl_bw [..., dn, T, d]``; computed once, when a plan is built."""
    flags = [(lvl_bw[..., o:o + w, :] == lvl_bw[..., o:o + 1, :]).all(dim=-2)
             for o, w in offsets]
    return torch.stack(flags, dim=-2).to(torch.uint8)


def launch_plan(chains: int, width: int, dtype=torch.float32,
                d: int = 2) -> str:
    """The layout (a key of LAYOUTS) of a set of ``chains`` chains whose
    widest level has ``width`` candidates, in ``dtype`` at ``d`` dims (see
    LAYOUTS' comment): staged for float32 at d <= STAGED_MAX_DIM with many
    chains over wide levels; the warp or block layout otherwise."""
    if (dtype == torch.float32 and d <= STAGED_MAX_DIM
            and chains >= STAGED_MIN_CHAINS and width >= STAGED_MIN_WIDTH):
        return "staged"
    if chains >= WARP_MIN_CHAINS or width <= WARP_MAX_WIDTH:
        return "warp"
    return "block"


@functools.lru_cache(maxsize=64)
def _offsets_on(offsets: Tuple[Tuple[int, int], ...],
                device: torch.device) -> torch.Tensor:
    """The level offsets as an int32 ``[L, 2]`` tensor on ``device``,
    uploaded once."""
    return torch.as_tensor(offsets, dtype=torch.int32, device=device)


def _check(u, nrm, plans, mask, n_iter, codes, select, seeds):
    """Shapes, dtypes and the one device of the inputs; returns the
    device.  Raises on anything else."""
    b, dn, t_len, d = plans.lvl_mean.shape
    c = nrm.shape[1] if nrm.dim() == 3 else -1
    L = plans.n_levels
    bu, bn = dn * (1 + L * (1 + n_iter)), d * (L + 1)
    want = {"nrm": (nrm, (b, c, bn)), "mask": (mask, (b, dn, d)),
            "lvl_bw": (plans.lvl_bw, (b, dn, t_len, d)),
            "lvl_logw": (plans.lvl_logw, (b, dn, t_len)),
            "lvl_perm": (plans.lvl_perm, (b, dn, t_len))}
    if select == "cdf":
        if u is None or seeds is not None:
            raise ValueError("gibbs_chain draws cdf from the uniform stream "
                             "u and takes no seeds")
        want["u"] = (u, (b, c, bu))
    elif select == "gumbel":
        if u is not None or seeds is None:
            raise ValueError("gibbs_chain draws gumbel from the counter "
                             "seeds [B, 2] and takes no u")
        want["seeds"] = (seeds, (b, 2))
    else:
        raise ValueError(f"gibbs_chain draws cdf or gumbel, not {select!r}")
    bad = [f"{k} {tuple(x.shape)} (want {s})" for k, (x, s) in want.items()
           if tuple(x.shape) != s]
    bad += [f"{k} {tuple(x.shape)}" for k, x in (("t_mean", plans.t_mean),
                                                  ("t_bw", plans.t_bw))
            if x.dim() != 4 or tuple(x.shape[:2]) != (b, dn)
            or x.shape[3] != d or x.shape[2] < 1]
    offs = [tuple(int(v) for v in ow) for ow in plans.offsets]
    if (bad or c < 0 or n_iter < 0 or L < 1 or len(offs) != L
            or any(w < 1 or o < 0 or o + w > t_len for o, w in offs)
            or not 1 <= dn <= MAX_DENS or not 1 <= d <= MAX_DIM):
        raise ValueError(f"gibbs_chain: level [B, dn, T, d] = "
                         f"{tuple(plans.lvl_mean.shape)}, offsets {offs}, "
                         f"n_iter {n_iter} (dn, d at most {MAX_DENS}, "
                         f"{MAX_DIM}); {bad}")
    if codes is None or len(codes) != d or any(k not in (0, 1) for k in codes):
        raise ValueError(f"gibbs_chain: codes must be d = {d} of 0/1, got "
                         f"{codes}")
    floats = [x for x in (u, nrm, plans.t_mean, plans.t_bw, plans.lvl_mean,
                          plans.lvl_bw, plans.lvl_logw) if x is not None]
    tensors = floats + [x for x in (mask, plans.lvl_perm, seeds)
                        if x is not None]
    devs = {x.device for x in tensors}
    if len(devs) != 1 or next(iter(devs)).type not in ("cpu", "cuda"):
        raise ValueError("gibbs_chain: inputs must all lie on the CPU or on "
                         f"one CUDA device, got {sorted(map(str, devs))}")
    dts = {x.dtype for x in floats}
    if (len(dts) != 1 or dts.pop() not in (torch.float32, torch.float64)
            or plans.lvl_perm.dtype != torch.int64
            or mask.dtype != torch.bool
            or (seeds is not None and seeds.dtype != torch.int64)):
        raise TypeError("gibbs_chain: float32 or float64 streams and plan of "
                        "one dtype, int64 lvl_perm and seeds and bool mask; "
                        f"got {[x.dtype for x in floats]}, "
                        f"{plans.lvl_perm.dtype}, {mask.dtype}")
    return next(iter(devs))


def gibbs_chain(u: Optional[torch.Tensor], nrm: torch.Tensor, plans,
                mask: torch.Tensor, n_iter: int, add_entropy: bool,
                codes: Sequence[int], select: str = "cdf",
                seeds: Optional[torch.Tensor] = None):
    """Every chain of ``B`` density sets, drawn with ``select``: ``cdf``
    from ``u``, or ``gumbel`` from the sets' counter seeds ``seeds [B, 2]``
    (int64; ``u`` None), chain ``c`` of a set being its global chain ``c``.

    ``u [B, C, bu]`` and ``nrm [B, C, bn]``: the streams in the reference's
    consumption order (``ops/gibbs.py::_run_chain``); ``plans``: a
    ``_SetPlans`` (``t_mean``/``t_bw`` ``[B, dn, 2N, d]``, ``lvl_mean``/
    ``lvl_bw`` ``[B, dn, T, d]``, ``lvl_logw``/``lvl_perm`` ``[B, dn, T]``,
    ``offsets``, ``n_levels``, ``lvl_uniform [B, dn, L, d]``);
    ``mask [B, dn, d]`` bool; ``codes`` per dim (:func:`hook_codes`).
    Returns ``points [B, C, d]``, final labels ``[B, C, dn]`` and per-level
    labels ``[B, C, L, dn]``, as ``_run_chain``.  The layout is
    :func:`launch_plan`'s: staged for float32 at d <= 3 with many chains
    over wide levels, the warp or block layout for the other shapes."""
    global LAUNCHES
    dev = _check(u, nrm, plans, mask, n_iter, codes, select, seeds)
    if dev == _CPU:
        return gibbs_chain_ref(u, nrm, plans, mask, n_iter, add_entropy, codes,
                               select, seeds)
    b, dn, _, d = plans.lvl_mean.shape
    c, L = nrm.shape[1], plans.n_levels
    lm, lb, lw, lp = plans.lvl_mean, plans.lvl_bw, plans.lvl_logw, \
        plans.lvl_perm
    tm, tb = plans.t_mean, plans.t_bw
    if (lm.stride()[2:] != (d, 1) or lb.stride() != lm.stride()
            or lw.stride(2) != 1 or lp.stride() != lw.stride()
            or tm.stride(3) != 1 or tb.stride() != tm.stride()
            or (u is not None and u.stride(2) != 1) or nrm.stride(2) != 1):
        raise ValueError("gibbs_chain: each (set, density) slab of the plan "
                         "must be contiguous, lvl_bw laid out as lvl_mean, "
                         "lvl_perm as lvl_logw, t_bw as t_mean, and the "
                         "streams' rows contiguous")
    uni = plans.lvl_uniform
    if tuple(uni.shape) != (b, dn, L, d) or uni.device != dev:
        raise ValueError(f"gibbs_chain: lvl_uniform {tuple(uni.shape)} on "
                         f"{uni.device}, want {(b, dn, L, d)} on {dev}")
    width = max(w for _, w in plans.offsets)
    out = _launch(_load(), launch_plan(c, width, lm.dtype, d), u, nrm, plans,
                  mask, n_iter, add_entropy, codes, seeds)
    if b * c:
        LAUNCHES += 1
    return out


def _launch(lib, layout: str, u, nrm, plans, mask, n_iter, add_entropy,
            codes, seeds=None):
    """One ``kde_gibbs_chain`` call of ``lib`` with ``layout`` on
    inputs :func:`gibbs_chain` has checked (gumbel where ``seeds`` is
    given, cdf from ``u`` otherwise); raises on a refused launch."""
    b, dn, _, d = plans.lvl_mean.shape
    c, L = nrm.shape[1], plans.n_levels
    lm, lb, lw, lp = plans.lvl_mean, plans.lvl_bw, plans.lvl_logw, \
        plans.lvl_perm
    tm, tb = plans.t_mean, plans.t_bw
    dev = lm.device
    uni = plans.lvl_uniform.to(torch.uint8).contiguous()
    mask = mask.contiguous()
    out_x = torch.empty((b, c, d), dtype=lm.dtype, device=dev)
    out_lv = torch.empty((b, c, L, dn), dtype=torch.int64, device=dev)
    two_pi, inv_two_pi = _gs._two_pi(lm.dtype)
    offs = _offsets_on(tuple((int(o), int(w)) for o, w in plans.offsets), dev)
    seeds = None if seeds is None else seeds.contiguous()
    us = (0, 0) if u is None else u.stride()[:2]
    with torch.cuda.device(dev):
        rc = lib.kde_gibbs_chain(
            lm.element_size(), LAYOUTS[layout], int(seeds is not None),
            tm.data_ptr(), tb.data_ptr(), tm.stride(0), tm.stride(1),
            lm.data_ptr(), lb.data_ptr(), lw.data_ptr(), lp.data_ptr(),
            lm.stride(0), lm.stride(1), lw.stride(0), lw.stride(1),
            offs.data_ptr(), uni.data_ptr(), mask.data_ptr(),
            _gs._codes_on(tuple(codes), dev).data_ptr(),
            None if u is None else u.data_ptr(), *us,
            None if seeds is None else seeds.data_ptr(), nrm.data_ptr(),
            nrm.stride(0), nrm.stride(1), out_x.data_ptr(), out_lv.data_ptr(),
            b, c, dn, d, L, n_iter, int(bool(add_entropy)), two_pi, inv_two_pi,
            _gs.LOG_DEAD, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"kde_gibbs_chain launch failed: CUDA error {rc} "
                           f"({layout} layout)")
    return out_x, out_lv[:, :, L - 1], out_lv


def gibbs_chain_ref(u: Optional[torch.Tensor], nrm: torch.Tensor, plans,
                    mask: torch.Tensor, n_iter: int, add_entropy: bool,
                    codes: Sequence[int], select: str = "cdf",
                    seeds: Optional[torch.Tensor] = None):
    """Plain twin of :func:`gibbs_chain`, on any device: the eager
    ``ops/gibbs.py::_run_chain`` with ``select``'s draws, every selection
    through ``gibbs_select_ref`` (gumbel's noise from the twin's counter
    draw, ``ops/gibbs.py::_gumbel_noise``)."""
    from . import gibbs as _g       # ops/gibbs.py imports this module

    def choose(stage, lvl):
        mean, var, label = _gs.gibbs_select_ref(
            *lvl, stage.js, stage.mu, stage.cov, stage.active, codes,
            u=stage.u, seeds=seeds, sel0=stage.sel)
        return [(mean[:, :, i], var[:, :, i], label[:, :, i])
                for i in range(len(stage.js))]
    return _g._run_chain(u, nrm, plans, mask, n_iter, add_entropy, select,
                         seeds, hooks=hooks_of(codes), choose=choose)
