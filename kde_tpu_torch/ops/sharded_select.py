"""The local work of one kernel-sharded Gibbs selection, between its
collectives (the port's K6; on the TPU this is part of the XLA-fused
``shard_map`` program of ``kde_tpu/parallel/gibbs_kernel_sharded.py``:
``_select_sharded`` :158-187 and the one-hot stats of ``_run_chain_ks``
:190-283).

``parallel/gibbs_kernel_sharded.py`` runs a selection as six phases
around six collectives, in the JAX package's order::

    st    = prepare(rows, uniform)                 (once a stage)
    m     = local_max(st)                          -> pmax: m0
    s     = shifted_sum(st, m0)                    -> psum: ssum
    dead, mfb = dead_max(m0, ssum, m, real)        -> pmax: gmax
    e     = exp_sum(st, gmax, dead)                -> all_gather: tots
    n     = count_below(st, gmax, dead, tots, sid, u)    -> psum: z
    stats = owner_stats(stats, js, z, n_shards, sid)     -> psum

where ``rows`` (:class:`Rows`) holds this shard's level slice and the
stage's densities ``js``, chains and hooks, and ``uniform [dn, d]`` says
where every candidate of the slice has the same bandwidth
(:func:`uniform_dims`, taken once when the engine builds its level
slices).  :func:`prepare` checks the rows, plans the launch
(:func:`plan`) and packs its pointers, strides, codes, flags and
``[rows, chunks]`` scratch once for the stage (a :class:`Stage`); the
row phases then make one checked ctypes call each.  One call covers every
density of the stage and every chain of the block, and no phase keeps a
``[|js|, C, w]`` tensor on the card: the kernels recompute the logits in
each pass.  ``count_below`` on the card reads the chunk sums of the
stage's ``exp_sum`` (on the same ``gmax`` and ``dead``), so it takes the
:class:`Stage` that ran it.  CUDA tensors launch the hand-written kernels
of ``csrc/sharded_select.cu`` (built with nvcc ``--fmad=false`` into
``_build/`` at the first launch; the candidate logit is
``csrc/gibbs_logit.cuh``'s ``row_logit``, bitwise K2's
``candidate_logit``); CPU tensors take each entry's plain twin ``*_ref``,
the eager ops of ``ops/gibbs.py``, on the :class:`Rows`.  A failed build,
a refused launch or an input the kernel does not take raises; nothing
falls back.  A user's own ``diffop``, which no kernel runs, raises here on
the card: the engine sends it to the twins by design and counts each such
stage in ``TWIN_STAGES``.

The twin of ``shifted_sum`` makes the kernel's one cut: a row whose global
max reaches log(1e-99) gives 1, not its sum.  The global sum holds
exp(0) = 1 and no negative term, so such a row is live either way: the
degenerate test, and so every label, is the JAX package's.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .gibbs_select import _codes_on, _two_pi, diff_codes
from .tiled_eval import _sm_count, nvcc_build

# Launches of the kernels; a run sets it to 0 and reads it to show the path
# went through them.
LAUNCHES = 0
# Selection stages the kernel-sharded engine ran on the twins (CPU tensors,
# a user's diffop), counted on any device.
TWIN_STAGES = 0

# The launch plan (csrc/sharded_select.cu's constants where named so).
MAX_ROWS = 16            # rows of a tile block, a warp each (kMaxRows)
STAGES = 3               # ring slots of a tile block (kStages)
SLOT_BYTES = 10240       # a ring slot holds about this many bytes of
                         # candidates, a multiple of 32 of them
RESIDENT_PER_SM = 2      # tile blocks an SM holds at once (512 threads at
                         # up to 64 registers): the grid is one wave of them
MAX_CHUNKS = 32          # chunks a row at most: the scratch is [rows, 32]
                         # float64, kilobytes
COUNT_WARP_MAX = 1024    # count_below: a warp a row up to this chunk,
COUNT_THREADS = 512      # a block of this many threads above (kCtaThreads)
COUNT_WARP_ROWS = 8      # rows of a warp-route block (kWarpRows)
SMEM_MAX_BYTES = 232448  # dynamic shared memory a block may use (kSmemMax)

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


class Plan(NamedTuple):
    """A launch of the row phases: ``rows`` rows (a warp each) in a tile
    block of one density, ``tiles`` row tiles over the stage's densities,
    the level's ``w`` candidates cut into ``chunks`` chunks of ``chunk``
    (the last may hold fewer; a multiple of ``slot``, the candidates of a
    ring slot), ``count_group`` threads a row of ``count_below`` and each
    launch's dynamic shared memory."""
    rows: int
    tiles: int
    chunks: int
    chunk: int
    slot: int
    count_group: int
    tile_smem: int
    count_smem: int

    @property
    def blocks(self) -> int:
        """Blocks of a tile launch (local_max, shifted_sum, exp_sum)."""
        return self.tiles * self.chunks


def _row_bytes(d: int, itemsize: int) -> int:
    """Shared memory of a row's constants where d is not 1, 2 or 3."""
    return 4 * d * itemsize + d


def plan(c: int, n_js: int, w: int, d: int, itemsize: int,
         sms: int = 132) -> Plan:
    """The launch of ``c`` chains x ``n_js`` densities over ``w``
    candidates in ``d`` dims of ``itemsize`` bytes on a card of ``sms``
    SMs: tiles of up to MAX_ROWS rows of one density (a power of two), the
    level cut into chunks of whole ring slots, as many as one wave of
    RESIDENT_PER_SM blocks an SM holds where the level is wide enough (a
    second, partial wave would double the time; more waves of smaller
    chunks measured no faster and lengthen the scratch), at most
    MAX_CHUNKS: the ``[rows, chunks]`` scratch, about 16 x 8 bytes a
    block, does not grow with ``w``.  Raises ``ValueError`` where a
    block's shared memory cannot hold the stage at ``d``."""
    if c < 0 or n_js < 1 or w < 1 or d < 1 or itemsize not in (4, 8):
        raise ValueError(f"sharded_select: plan of c = {c}, |js| = {n_js}, "
                         f"w = {w}, d = {d}, itemsize {itemsize}")
    generic = not 1 <= d <= 3
    per = (2 * d + 1) * itemsize
    slot = max(32, SLOT_BYTES // per // 32 * 32)
    rows = 1
    while rows < min(max(c, 1), MAX_ROWS):
        rows *= 2

    def tile_smem(r):
        head = -(-r * _row_bytes(d, itemsize) // 16) * 16 if generic else 0
        return head + STAGES * slot * per
    while tile_smem(rows) > SMEM_MAX_BYTES and rows > 1:
        rows //= 2
    tiles = n_js * -(-c // rows)
    n = max(1, min(MAX_CHUNKS, RESIDENT_PER_SM * sms // max(tiles, 1),
                   -(-w // slot)))
    chunk = -(-(-(-w // n)) // slot) * slot
    group = 32 if chunk <= COUNT_WARP_MAX else COUNT_THREADS
    group_rows = COUNT_WARP_ROWS if group == 32 else 1
    count_smem = group_rows * _row_bytes(d, itemsize) if generic else 0
    if max(tile_smem(rows), count_smem) > SMEM_MAX_BYTES:
        raise ValueError(f"sharded_select: d = {d} is more than the "
                         "kernel's shared memory holds")
    return Plan(rows, tiles, -(-w // chunk), chunk, slot, group,
                tile_smem(rows), count_smem)


def uniform_dims(bw: torch.Tensor) -> torch.Tensor:
    """``[dn, d]`` bool: where every candidate of the level slice ``bw
    [dn, w, d]`` has its first candidate's bandwidth, bit for bit (so
    ``log c`` taken once a row is each candidate's value; -0.0 and 0.0
    differ).  Padded slots repeat a real node, so padding keeps a level
    uniform."""
    bits = bw.view(torch.int64 if bw.element_size() == 8 else torch.int32)
    return (bits == bits[:, :1]).all(dim=1)


class _StageC(ctypes.Structure):
    """csrc/sharded_select.cu's ``Stage``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "mean", "bw", "logw", "mu", "cov", "active", "codes", "uniform",
        "part", "part_e", "counters")]
        + [("ms_j", ctypes.c_longlong), ("ls_j", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in (
            "itemsize", "C", "J", "j0", "dn", "w", "d", "R", "chunks",
            "chunk", "slot", "count_group")]
        + [(n, ctypes.c_double) for n in ("two_pi", "inv_two_pi",
                                          "log_dead")])


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
        lib.kde_k6_phase.argtypes = ([i] + [vp] * 5 + [i] * 2 + [vp]
                                     + [ll] * 2 + [vp] * 2)
        lib.kde_k6_smem.argtypes = [vp, i]
        lib.kde_k6_smem.restype = ll
        lib.kde_k6_stage_bytes.argtypes = []
        lib.kde_k6_dead_max.argtypes = ([i] + [vp] * 4 + [i] * 2 + [f]
                                        + [vp] * 3)
        lib.kde_k6_owner_stats.argtypes = ([vp] * 2 + [ll] + [i] * 8
                                           + [vp] * 2)
        for fn in (lib.kde_k6_phase, lib.kde_k6_stage_bytes,
                   lib.kde_k6_dead_max, lib.kde_k6_owner_stats):
            fn.restype = i
        if lib.kde_k6_stage_bytes() != ctypes.sizeof(_StageC):
            raise RuntimeError("sharded_select: csrc Stage is "
                               f"{lib.kde_k6_stage_bytes()} bytes, the "
                               f"wrapper's {ctypes.sizeof(_StageC)}")
        _lib = lib
    return _lib


def _device(tensors) -> torch.device:
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1 or next(iter(devs)).type not in ("cpu", "cuda"):
        raise ValueError("sharded_select: inputs must all lie on the CPU or "
                         f"on one CUDA device, got {sorted(map(str, devs))}")
    return devs.pop()


def _check(rows: Rows) -> Tuple[torch.device, Optional[tuple]]:
    """Shapes, dtypes and the one device of ``rows``; returns the device
    and the kernel's difference codes (None for a user's diffop)."""
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
    dev = _device([mean, bw, logw, mu, cov, active])
    dts = {t.dtype for t in (mean, bw, logw, mu, cov) if t is not None}
    if (len(dts) != 1 or next(iter(dts)) not in _FLOATS
            or active.dtype != torch.bool):
        raise TypeError("sharded_select: float32 or float64 mean, bw, logw, "
                        "mu and cov of one dtype and bool active; got "
                        f"{sorted(map(str, dts))}, {active.dtype}")
    return dev, diff_codes(diffop, d)


class Stage:
    """One selection's rows, checked and packed once for the row phases
    (:func:`prepare`).  ``rows``, ``device``, ``dtype`` and ``shape``
    ``(|js|, C)``; on the card also ``plan`` (:func:`plan`), the
    ``uniform [dn, d]`` flags, the ``[rows, chunks]`` scratch and the
    kernel's packed arguments.  ``count_below`` reads the chunk sums of
    the stage's last ``exp_sum``."""

    def __init__(self, rows: Rows, uniform: Optional[torch.Tensor] = None):
        dev, codes = _check(rows)
        self.rows, self.device = rows, dev
        self.dtype = rows.mean.dtype
        self.shape = (len(rows.js), rows.mu.shape[0])
        self.plan = self.uniform = None
        self._esum = None
        if dev.type == "cpu":
            return
        if codes is None:
            raise ValueError("sharded_select: a user's diffop runs on the "
                             "twins (*_ref), not on the card's kernels")
        mean, bw, logw, js, mu, cov, active, _ = rows
        dn, w, d = mean.shape
        if (mean.stride()[1:] != (d, 1) or bw.stride() != mean.stride()
                or logw.stride(1) != 1):
            raise ValueError("sharded_select: each density's slab of the "
                             "level must be contiguous, bw laid out as mean")
        if uniform is None:
            uniform = uniform_dims(bw)
        elif (tuple(uniform.shape) != (dn, d) or uniform.dtype != torch.bool
              or uniform.device != dev):
            raise ValueError(f"sharded_select: uniform must be [{dn}, {d}] "
                             f"bool on {dev}, got {tuple(uniform.shape)} "
                             f"{uniform.dtype} on {uniform.device}")
        item = mean.element_size()
        c, n_js = self.shape[1], self.shape[0]
        pl = plan(c, n_js, w, d, item, _sm_count(dev.index))
        self.plan = pl
        mu, active = mu.contiguous(), active.contiguous()
        cov = None if cov is None else cov.contiguous()
        self.uniform = uniform.contiguous()
        codes_t = _codes_on(codes, dev)
        # one zeroed buffer: the [rows, chunks] partials, then the tiles'
        # counters (which every launch leaves at 0).  local_max's and
        # shifted_sum's partials (the chain's type) and exp_sum's (float64,
        # which count_below reads) share the partials: each phase's are
        # dead before the next launch writes its own
        at_n = -(-n_js * c * pl.chunks * 8 // 16) * 16
        scratch = torch.zeros(at_n + 4 * max(pl.tiles, 1),
                              dtype=torch.uint8, device=dev)
        base = scratch.data_ptr()
        two_pi, inv_two_pi = _two_pi(mean.dtype)
        self._c = _StageC(
            mean.data_ptr(), bw.data_ptr(), logw.data_ptr(), mu.data_ptr(),
            None if cov is None else cov.data_ptr(), active.data_ptr(),
            codes_t.data_ptr(), self.uniform.data_ptr(), base, base,
            base + at_n, mean.stride(0), logw.stride(0), item, c, n_js,
            js[0], dn, w, d, pl.rows, pl.chunks, pl.chunk, pl.slot,
            pl.count_group, two_pi, inv_two_pi, LOG_DEAD)
        self._addr = ctypes.addressof(self._c)
        self._keep = (mu, cov, active, codes_t, scratch)

    def out(self, dtype) -> torch.Tensor:
        """A ``[|js|, C]`` output of a row phase."""
        return torch.empty(self.shape, dtype=dtype, device=self.device)

    def launch(self, phase: int, out: torch.Tensor, m0=None, gmax=None,
               dead=None, tots=None, sid: int = 0, u=None) -> torch.Tensor:
        """One row phase into ``out`` on inputs already checked and
        contiguous (``u`` any strides): the bare kernel call, counted."""
        global LAUNCHES
        ptr = lambda t: None if t is None else t.data_ptr()
        s = 1 if tots is None else tots.shape[0]
        u_c, u_j = (0, 0) if u is None else u.stride()
        idx = self.device.index
        args = (phase, self._addr, ptr(m0), ptr(gmax), ptr(dead), ptr(tots),
                s, sid, ptr(u), u_c, u_j, out.data_ptr(),
                torch._C._cuda_getCurrentRawStream(idx))
        if torch.cuda.current_device() == idx:
            rc = _load().kde_k6_phase(*args)
        else:
            with torch.cuda.device(idx):
                rc = _load().kde_k6_phase(*args)
        if rc != 0:
            raise RuntimeError(f"kde_k6_phase (phase {phase}) launch failed: "
                               f"CUDA error {rc}")
        if out.numel():
            LAUNCHES += 1
        return out


def prepare(rows: Rows, uniform: Optional[torch.Tensor] = None) -> Stage:
    """``rows`` checked and packed once for a stage's row phases (a
    :class:`Stage`); ``uniform [dn, d]`` bool, the slice's
    :func:`uniform_dims` (taken from ``rows.bw`` where None)."""
    return Stage(rows, uniform)


def _stage_of(rows: Union[Rows, Stage], *extra) -> Stage:
    """``rows`` as a :class:`Stage` (prepared here from a :class:`Rows`),
    with the phase's other inputs ``extra`` on its device."""
    st = rows if isinstance(rows, Stage) else Stage(rows)
    for t in extra:
        if t is not None and t.device != st.device:
            raise ValueError("sharded_select: inputs must all lie on the CPU "
                             f"or on one CUDA device, got {st.device} and "
                             f"{t.device}")
    return st


def _row_input(x, st: Stage, dtype, what):
    """A ``[|js|, C]`` input of a row phase, checked and contiguous."""
    if tuple(x.shape) != st.shape or x.dtype != dtype:
        raise ValueError(f"sharded_select: {what} must be {st.shape} "
                         f"{dtype}, got {tuple(x.shape)} {x.dtype}")
    return x.contiguous()


# ---------------------------------------------------------------------------
# the kernel entries; each takes its twin on CPU tensors
# ---------------------------------------------------------------------------

def local_max(rows: Union[Rows, Stage]) -> torch.Tensor:
    """``[|js|, C]``: the largest raw logit of each row on this shard."""
    st = _stage_of(rows)
    if st.device.type == "cpu":
        return local_max_ref(st.rows)
    return st.launch(_MAX, st.out(st.dtype))


def shifted_sum(rows: Union[Rows, Stage], m0: torch.Tensor) -> torch.Tensor:
    """``[|js|, C]``: ``sum(exp(l - ms0))`` in the chain's dtype, ``ms0``
    the global max ``m0`` (0 where it is -inf); 1 where ``m0`` reaches
    log(1e-99) (the module's note)."""
    st = _stage_of(rows, m0)
    m0 = _row_input(m0, st, st.dtype, "m0")
    if st.device.type == "cpu":
        return shifted_sum_ref(st.rows, m0)
    return st.launch(_SUM, st.out(st.dtype), m0=m0)


def exp_sum(rows: Union[Rows, Stage], gmax: torch.Tensor,
            dead: torch.Tensor) -> torch.Tensor:
    """``[|js|, C]`` float64: ``sum(exp(l' - gmax))``, ``l'`` the logits
    after the degenerate fallback of the ``dead`` rows, the exps in the
    chain's dtype.  On the card the stage keeps the chunk sums for
    :func:`count_below`."""
    st = _stage_of(rows, gmax, dead)
    g = _row_input(gmax, st, st.dtype, "gmax")
    dd = _row_input(dead, st, torch.bool, "dead")
    if st.device.type == "cpu":
        return exp_sum_ref(st.rows, g, dd)
    out = st.launch(_ESUM, st.out(torch.float64), gmax=g, dead=dd)
    st._esum = (gmax, dead)
    return out


def count_below(rows: Union[Rows, Stage], gmax: torch.Tensor,
                dead: torch.Tensor, tots: torch.Tensor, sid: int,
                u: torch.Tensor) -> torch.Tensor:
    """``[|js|, C]`` int64: the count of this shard's CDF entries
    ``(offset + local cumsum) / total`` below ``u [C, |js|]`` (any
    strides), in float64; ``tots [S, |js|, C]`` every shard's
    :func:`exp_sum` in shard order, ``offset`` the sum of those before
    shard ``sid``, ``total`` of all.  On the card ``rows`` is the
    :class:`Stage` whose :func:`exp_sum` ran on these ``gmax`` and
    ``dead``."""
    st = _stage_of(rows, gmax, dead, tots, u)
    g = _row_input(gmax, st, st.dtype, "gmax")
    dd = _row_input(dead, st, torch.bool, "dead")
    n_js, c = st.shape
    if (tots.dim() != 3 or tuple(tots.shape[1:]) != (n_js, c)
            or tots.dtype != torch.float64 or not 0 <= sid < tots.shape[0]
            or tuple(u.shape) != (c, n_js) or u.dtype != st.dtype):
        raise ValueError(f"sharded_select: tots [S, {n_js}, {c}] float64, "
                         f"0 <= sid < S and u [{c}, {n_js}] of the chain's "
                         f"dtype; got {tuple(tots.shape)} {tots.dtype}, sid "
                         f"{sid}, {tuple(u.shape)} {u.dtype}")
    if st.device.type == "cpu":
        return count_below_ref(st.rows, g, dd, tots, sid, u)
    if st is not rows or st._esum is None or st._esum[0] is not gmax \
            or st._esum[1] is not dead:
        raise ValueError("sharded_select: count_below on the card reads the "
                         "chunk sums of exp_sum(stage, gmax, dead): pass the "
                         "Stage it ran on, with the same gmax and dead")
    return st.launch(_COUNT, st.out(torch.int64), gmax=g, dead=dd,
                     tots=tots.contiguous(), sid=sid, u=u)


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
