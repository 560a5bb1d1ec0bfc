"""The device product plan's tree in hand-written kernels (the port's K8,
``csrc/tree_build.cu``; on the TPU the build is the XLA-fused jnp program of
``kde_tpu/ops/device_plan.py:140-210``, which has no Pallas kernel).

For every (set, density) of a plan the kernels compute what the plain twin
in ``ops/device_plan.py`` (``device_tree_stats`` and the eager assembly of
``batched_device_plans``, the plan's CPU route) computes: per depth, each
slice's most-spread coordinate (float64 sums, the first argmax) and a
stable sort of its positions by it; then the bottom-up moment sweep; then
the plan's slot arrays ``t_mean``, ``t_bw``, ``t_logw`` (``log(max(w,
tiny))``) and ``t_perm`` and, for a plan, its level arrays and
``lvl_uniform``.  The slices come from the recursion ``split = (lo + hi) //
2`` walked in the kernel (:func:`slice_bounds` is its mirror here), so no
per-depth index tensor is built or uploaded; only the level table is, once
per shape (``device_plan._level_table``).

:func:`launch_plan` gives each depth's route, chosen from the slice width:
slices of at most ``SUBTREE_MAX_WIDTH`` points are finished, every depth
below them and their moments, by one block each in one launch; wider ones
take the multi-block route a depth at a time (three launches: split dims,
chunk sorts, ranks), and one more launch sweeps the moments above the
subtrees; the level arrays take one more.  Densities go ``MAX_DENS`` to a
group of launches (the kernels' per-density arguments).  At 2 x 20,000
points a plan is 21 launches from one call.

:func:`launch` is the one entry (``batched_device_plans`` calls it for
CUDA tensors).  The kernels are built with nvcc (``--fmad=false``) into
``_build/`` at the first launch; a failed build, a refused launch or an
input the kernels do not take raises, and nothing falls back.
:data:`LAUNCHES` counts the kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Sequence

import torch

from . import gibbs_select as _gs
from .tiled_eval import nvcc_build

# Kernel launches; a run sets it to 0 and reads it to show the plan went
# through the kernels.
LAUNCHES = 0

# csrc/tree_build.cu's kMaxDens (densities a group of launches takes),
# kMaxLevels and kKeysOffset (a subtree block's keys follow its 32
# reduction slots)
MAX_DENS = 16
MAX_LEVELS = 64
KEYS_OFFSET = 256
SMEM_MAX_BYTES = 232448      # a block's shared memory on an H100
# The multi-block route sorts chunks of CHUNK positions in shared memory
# (a bitonic network), and a block finishes every slice of at most
# SUBTREE_MAX_WIDTH points (its depths, each position placed by counting
# the keys below its own, then its moments).  Both measured on an H100
# (chip_smoke.py --k8-routes, PERF.md §6): at 2 x 20,000 and 2 x 100,000
# points a build is fastest with the subtree launch taking slices of
# ~150-400 points and chunks of 1,024-2,048; one block sorting a whole
# 20,000-point slice took 5.6-7.0 ms against 0.6-0.9 ms.
CHUNK = 2048
SUBTREE_MAX_WIDTH = 512


def key_bytes(itemsize: int) -> int:
    """Bytes a position's key takes: 8 in float32 (the coordinate and the
    position in one word); float64 adds the 4-byte position apart."""
    return 8 if itemsize == 4 else 12


def subtree_smem(width: int, itemsize: int) -> int:
    """Dynamic shared memory of the subtree launch whose widest slice has
    ``width`` points: the reduction slots, then the keys."""
    return KEYS_OFFSET + width * key_bytes(itemsize)


def sort_smem(itemsize: int, chunk: int = CHUNK) -> int:
    """Dynamic shared memory of a multi-block sort of ``chunk`` keys."""
    return chunk * key_bytes(itemsize)


SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "tree_build.cu"
NVCC_FLAGS = _gs.NVCC_FLAGS

_lib = None
BUILD_LOG = ""
_FLOATS = (torch.float32, torch.float64)


def build() -> Path:
    """Compile ``csrc/tree_build.cu`` (once per source and flags) and return
    the shared library's path; a failed build raises."""
    global BUILD_LOG
    out, log = nvcc_build(SOURCE, NVCC_FLAGS, "tree_build")
    BUILD_LOG = log or BUILD_LOG
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.kde_tree_build.argtypes = ([i] * 6 + [vp] * 3 + [vp] * 9
                                       + [i] * 6 + [i] * 2 + [vp] * 8 + [vp])
        lib.kde_tree_build.restype = i
        _lib = lib
    return _lib


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def slice_bounds(n: int, k: int):
    """``[(lo, hi), ...]`` of the slices that still split at depth ``k`` of
    an ``n``-point tree, in position order: the kernel's walk of the
    recursion ``split = (lo + hi) // 2`` (``walk_path``), node ``t``'s bits
    the turns from the root, past a leaf through virtual nodes of size 1
    and 0."""
    out = []
    for t in range(1 << k):
        lo, hi = 0, n - 1
        for j in range(k - 1, -1, -1):
            mid = (lo + hi) // 2
            if (t >> j) & 1:
                lo = mid + 1
            else:
                hi = mid
        if hi > lo:
            out.append((lo, hi))
    return out


def _subtree_depth(n: int) -> int:
    """The first depth whose slices one block finishes: the multi-block
    route takes the depths above it."""
    k = 0
    while _ceil_div(n, 1 << k) > SUBTREE_MAX_WIDTH:
        k += 1
    return k


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, d: int, dtype=torch.float32):
    """Each depth's route for an ``n``-point tree in ``d`` dims: a tuple of
    dicts ``depth``, ``slices`` (those that split), ``width`` (the widest),
    ``route`` (``"multi"``: the multi-block route, a launch each of split
    dims, chunk sorts and ranks; ``"subtree"``: inside the one launch that
    finishes every slice of at most ``SUBTREE_MAX_WIDTH`` points),
    ``smem_bytes`` (the route's launch) and ``bytes`` (the depth's traffic
    read and written once: the points and the order).  Chosen from the
    slice width alone."""
    if dtype not in _FLOATS:
        raise TypeError(f"tree_build: float32 or float64, not {dtype}")
    item = torch.empty((), dtype=dtype).element_size()
    k0 = _subtree_depth(n)
    rows, k = [], 0
    while _ceil_div(n, 1 << k) >= 2:
        s = 1 << k
        q, rem = divmod(n, s)
        slices = (s - rem if q >= 2 else 0) + (rem if q + 1 >= 2 else 0)
        multi = k < k0
        rows.append(dict(
            depth=k, slices=slices, width=_ceil_div(n, s),
            route="multi" if multi else "subtree",
            smem_bytes=(sort_smem(item) if multi
                        else subtree_smem(_ceil_div(n, 1 << k0), item)),
            bytes=n * d * item + 8 * n))
        k += 1
    return tuple(rows)


def workspace_bytes(npts: Sequence[int], itemsize: int, nodes: int) -> int:
    """Device bytes one plan's build (:func:`launch` with a level table)
    takes beyond the plan's own tensors: the order's two int32 buffers, the
    slot arrays the levels are gathered from and the plan drops (the
    weights the sweep reads, ``t_logw`` and the int64 ``t_perm``), the
    multi-block route's keys and split dims where a density takes it, and
    the cached level table (``nodes`` level slots over all densities)."""
    dn, max_n = len(npts), max(npts)
    k0 = max(_subtree_depth(n) for n in npts)
    total = (2 * dn * max_n * 4 + dn * 2 * max_n * (2 * itemsize + 8)
             + nodes * 5)
    if k0:
        total += dn * max_n * key_bytes(itemsize)
        total += dn * (1 << (k0 - 1)) * 4
    return total


def _threads(width: int) -> int:
    return 1024 if width > 4096 else 512 if width > 1024 else 256


def _check(ins, dtype):
    """Shapes, dtypes and the one CUDA device of ``ins`` (each density's
    ``points [B, n, d]``, ``var [B, n, d]``, ``w [B, n]``); returns the
    device.  Raises on anything else."""
    flat = [x for trio in ins for x in trio]
    if not all(isinstance(x, torch.Tensor) for x in flat):
        raise TypeError("tree_build: tensors only")
    if not ins:
        raise ValueError("tree_build: no densities")
    devs = {x.device for x in flat}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError("tree_build: inputs must all lie on one CUDA "
                         f"device, got {sorted(map(str, devs))}")
    if dtype not in _FLOATS or any(x.dtype != dtype for x in flat):
        raise TypeError("tree_build: float32 or float64 inputs of one dtype, "
                        f"got {[x.dtype for x in flat]}")
    b, _, d = ins[0][0].shape if ins[0][0].dim() == 3 else (0, 0, 0)
    for p, v, w in ins:
        if (p.dim() != 3 or p.shape[0] != b or p.shape[2] != d
                or p.shape[1] < 1 or d < 1 or b < 1
                or tuple(v.shape) != tuple(p.shape)
                or tuple(w.shape) != tuple(p.shape[:2])):
            raise ValueError(
                f"tree_build: points/var [B, N, d] and w [B, N] of one B and "
                f"d, got {tuple(p.shape)}, {tuple(v.shape)}, "
                f"{tuple(w.shape)}")
        if not all(x.is_contiguous() for x in (p, v, w)):
            raise ValueError("tree_build: contiguous inputs only")
    return next(iter(devs))


def launch(ins, dtype, two_n: int, level_table=None):
    """One build of the densities ``ins`` (each ``(points [B, n, d], var
    [B, n, d], w [B, n])``, contiguous, of ``dtype``, on one card): returns
    the slot arrays ``t_mean``, ``t_bw``, ``t_logw``, ``t_perm`` ``[B, dn,
    two_n, ...]`` and the swept weights ``wts`` (slots past a density's
    ``2 n`` hold 0, 1, -inf, 0 and 0) and, with ``level_table = (offsets,
    nodes [dn, T] int32, valid [dn, T] uint8)`` on the card, ``lvl_mean``,
    ``lvl_bw``, ``lvl_logw``, ``lvl_perm``, ``lvl_uniform``.  Raises on any
    input the kernels do not take."""
    return _launch_routes(ins, dtype, two_n, level_table, None, CHUNK)


def _launch_routes(ins, dtype, two_n, level_table, k0, chunk):
    """:func:`launch` with the multi-block sort's ``chunk`` and, unless
    None, the depth ``k0`` (per density) at which the subtree launch takes
    over given, for timing the routes against each other
    (``chip_smoke.py --k8-routes``)."""
    global LAUNCHES
    dev = _check(ins, dtype)
    b, d = ins[0][0].shape[0], ins[0][0].shape[2]
    dn = len(ins)
    npts = [p.shape[1] for p, _, _ in ins]
    item = torch.empty((), dtype=dtype).element_size()
    if two_n < 2 * max(npts):
        raise ValueError(f"tree_build: {two_n} slots for {max(npts)} points")
    if k0 is None:
        k0 = [_subtree_depth(n) for n in npts]
    max_n, max_k0 = max(npts), max(k0)
    width = max(_ceil_div(n, 1 << k) for n, k in zip(npts, k0))
    if subtree_smem(width, item) > SMEM_MAX_BYTES:
        raise ValueError(f"tree_build: subtrees from depths {k0} are wider "
                         "than a block's shared memory")
    new = lambda *s, dt=dtype: torch.empty(s, dtype=dt, device=dev)
    out = dict(t_mean=new(b, dn, two_n, d), t_bw=new(b, dn, two_n, d),
               t_logw=new(b, dn, two_n),
               t_perm=new(b, dn, two_n, dt=torch.int64),
               wts=new(b, dn, two_n))
    idx = new(2, b, dn, max_n, dt=torch.int32)
    keys = ranks = dims = None
    max_slices = 1 << max(max_k0 - 1, 0)
    if max_k0:
        keys = new(b, dn, max_n, dt=torch.int64)
        if item == 8:
            ranks = new(b, dn, max_n, dt=torch.int32)
        dims = new(b, dn, max_slices, dt=torch.int32)
    n_lv = t_len = 0
    offs = nodes = valid = None
    if level_table is not None:
        offsets, nodes, valid = level_table
        n_lv, t_len = len(offsets), nodes.shape[1]
        if (n_lv > MAX_LEVELS or tuple(nodes.shape) != (dn, t_len)
                or nodes.dtype != torch.int32 or valid.dtype != torch.uint8
                or tuple(valid.shape) != (dn, t_len)
                or nodes.device != dev or valid.device != dev):
            raise ValueError("tree_build: the level table must be int32 "
                             f"nodes and uint8 valid [{dn}, T] on {dev}, at "
                             f"most {MAX_LEVELS} levels")
        offs = (ctypes.c_int * (2 * n_lv))(
            *[int(v) for ow in offsets for v in ow])
        out.update(lvl_mean=new(b, dn, t_len, d), lvl_bw=new(b, dn, t_len, d),
                   lvl_logw=new(b, dn, t_len),
                   lvl_perm=new(b, dn, t_len, dt=torch.int64),
                   lvl_uniform=new(b, dn, n_lv, d, dt=torch.uint8))
    ptr = lambda x: None if x is None else x.data_ptr()
    ins_ptrs = (ctypes.c_ulonglong * (3 * dn))(
        *[x.data_ptr() for trio in ins for x in trio])
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.kde_tree_build(
            item, b, dn, d, max_n, two_n, (ctypes.c_int * dn)(*npts),
            (ctypes.c_int * dn)(*k0), ins_ptrs, ptr(out["t_mean"]),
            ptr(out["t_bw"]), ptr(out["t_logw"]), ptr(out["t_perm"]),
            ptr(out["wts"]), ptr(idx), ptr(keys), ptr(ranks), ptr(dims),
            max_slices, chunk, _threads(width), width,
            subtree_smem(width, item), sort_smem(item, chunk), n_lv, t_len,
            offs, ptr(nodes), ptr(valid), ptr(out.get("lvl_mean")),
            ptr(out.get("lvl_bw")), ptr(out.get("lvl_logw")),
            ptr(out.get("lvl_perm")), ptr(out.get("lvl_uniform")),
            torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"kde_tree_build launch failed: CUDA error {rc}")
    for g in range(0, dn, MAX_DENS):
        gk0 = max(k0[g:g + MAX_DENS])
        LAUNCHES += 3 * gk0 + 1 + (gk0 > 0)
    LAUNCHES += int(level_table is not None)
    return out
