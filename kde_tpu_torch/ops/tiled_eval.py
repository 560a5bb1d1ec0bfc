"""Tiled weighted log-sum-exp Gaussian-mixture evaluation (ports
``kde_tpu/ops/pallas_eval.py``, the TPU kernel K1).

``tiled_log_eval`` launches the hand-written CUDA kernel
``csrc/tiled_eval.cu`` for CUDA tensors and takes the plain twin
``tiled_log_eval_ref`` for CPU tensors.  Both compute

    out[m] = log sum_n w_n prod_k N(q_mk; mu_nk, var_nk)

with the direct ``(q - mu)^2 / var + log var`` form, never materializing the
``[M, N]`` logits in device memory.  With ``loo``, component
``m + diag`` is left out of query ``m`` (``diag = 0``: the diagonal; a
shard of the ``N x N`` pairs passes its query rows' global start minus
its components') and the caller applies the ``-log1p(-w)`` rescale.

The kernel is built with ``nvcc`` into ``kde_tpu_torch/_build/`` the first
time it is launched, and loaded with ``ctypes``.  A failed build raises
with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

LOG_2PI = math.log(2.0 * math.pi)

# Launches of the CUDA kernel; a run resets it to 0 and reads it to show the
# main path went through the kernel.
LAUNCHES = 0

MAX_DIM = 16                  # kMaxDim in csrc/tiled_eval.cu
MAX_SPLITS = 8                # kMaxSplits: the portable cluster size
THREADS = (64, 128)           # kMinThreads, kMaxThreads
SPLIT_ALIGN = 32              # splits start on a multiple of every chunk size

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "tiled_eval.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Resident threads an SM needs before its SFU is kept busy, and the fixed
# cost of one block (staging, the cluster merge) in pair-equivalents: the
# launch plan's cost model.
_SAT_THREADS = 640
_BLOCK_COST = 8192

_lib = None
BUILD_LOG = ""
_CPU = torch.device("cpu")


class LaunchPlan(NamedTuple):
    """How one ``tiled_log_eval`` call is cut: ``threads`` per block, each
    with ``rows_per_thread`` queries (a block holds ``threads *
    rows_per_thread``); the component axis in ``splits`` ranges of
    ``per_split`` (one cluster of ``splits`` blocks per query block);
    ``grid = (query blocks, splits)``."""
    threads: int
    rows_per_thread: int
    splits: int
    per_split: int
    grid: Tuple[int, int]


def rows_per_thread(d: int) -> int:
    """Queries a thread keeps in registers: ``Shape<DS>::R`` of
    csrc/tiled_eval.cu (d = 9..16 run at the padded widths 12 and 16).
    The kernel refuses a launch whose ``rows_per_thread`` differs."""
    return 4 if 3 <= d <= 8 else 2


def plans(m: int, n: int, d: int, sms: int):
    """Every plan of an ``[m, d]`` x ``[n, d]`` evaluation on a card with
    ``sms`` SMs, 64 or 128 threads a block by 1..MAX_SPLITS component
    splits (none empty), each with its estimated time of the busiest SM:
    its blocks (all resident at once) times the pairs of one block, slowed
    when fewer than ``_SAT_THREADS`` threads share the SM, plus a fixed cost
    per block.  Yields ``(cost, LaunchPlan)``."""
    rpt = rows_per_thread(d)
    for threads in THREADS:
        rows = threads * rpt
        blocks_m = max(1, -(-m // rows))
        for splits in range(1, MAX_SPLITS + 1):
            per_split = max(SPLIT_ALIGN,
                            -(-(-(-n // splits)) // SPLIT_ALIGN) * SPLIT_ALIGN)
            if splits > 1 and (splits - 1) * per_split >= n:
                continue
            per_sm = -(-blocks_m * splits // sms)
            busy = min(1.0, per_sm * threads / _SAT_THREADS)
            cost = per_sm * (rows * per_split / busy + _BLOCK_COST)
            yield cost, LaunchPlan(threads, rpt, splits, per_split,
                                   (blocks_m, splits))


@functools.lru_cache(maxsize=256)
def launch_plan(m: int, n: int, d: int, sms: int) -> LaunchPlan:
    """The plan of :func:`plans` with the least estimated cost."""
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"tiled_log_eval: d={d} outside 1..{MAX_DIM}")
    return min(plans(m, n, d, sms), key=lambda cp: cp[0])[1]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit's nvcc")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def source_bytes(source: Path) -> bytes:
    """``source``'s bytes followed by those of every local header it
    includes (``#include "..."``, resolved beside the including file), in
    the order they are first included."""
    seen, out, todo = set(), [], [Path(source)]
    while todo:
        path = todo.pop(0).resolve()
        if path in seen:
            continue
        seen.add(path)
        data = path.read_bytes()
        out.append(data)
        todo += [path.parent / m.decode()
                 for m in _LOCAL_INCLUDE.findall(data)]
    return b"".join(out)


def nvcc_build(source: Path, flags, stem: str) -> Tuple[Path, str]:
    """Compile ``source`` with ``flags`` into
    ``_build/lib<stem>_<hash of source, its local headers and flags>.so``,
    once: each process compiles to its own temporary file and renames it
    into place.  Returns the library's path and nvcc's output ("" when it
    was built already); a failed build raises with that output."""
    tag = hashlib.sha256(source_bytes(source) + " ".join(flags).encode()
                         ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{stem}_{tag}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    return out, log


def build() -> Path:
    """Compile ``csrc/tiled_eval.cu`` (once per source content) and return
    the shared library's path."""
    global BUILD_LOG
    out, log = nvcc_build(SOURCE, NVCC_FLAGS, "tiled_eval")
    BUILD_LOG = log or BUILD_LOG
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.kde_tiled_log_eval
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(query, means, var, weights):
    if (query.dim() != 2 or means.dim() != 2 or var.shape != means.shape
            or query.shape[1] != means.shape[1]
            or weights.shape != means.shape[:1]):
        raise ValueError(
            f"tiled_log_eval needs query [M, d], means/var [N, d], weights "
            f"[N]; got {tuple(query.shape)}, {tuple(means.shape)}, "
            f"{tuple(var.shape)}, {tuple(weights.shape)}")


def tiled_log_eval(query: torch.Tensor, means: torch.Tensor,
                   var: torch.Tensor, weights: torch.Tensor,
                   loo: bool = False, diag: int = 0) -> torch.Tensor:
    """``log p`` of the mixture at each query row (``[M, d]`` queries,
    ``[N, d]`` means and variances, ``[N]`` weights) -> ``[M]``; with
    ``loo``, query ``m`` leaves out component ``m + diag`` (any ``diag``:
    one at or beyond ``N``, or at or below ``-M``, leaves out nothing).

    CPU tensors take :func:`tiled_log_eval_ref`.  CUDA tensors launch the
    kernel once (it prepares its own inverse variances and log weights and
    merges its splits on chip); they must all be float32, contiguous and on
    one device, with ``d <= MAX_DIM``, or this raises."""
    global LAUNCHES
    _check(query, means, var, weights)
    if {t.device for t in (query, means, var, weights)} == {_CPU}:
        return tiled_log_eval_ref(query, means, var, weights, loo, diag=diag)
    dev = _cuda_device(query, means, var, weights)
    m, d = query.shape
    out = _launch(query, means, var, weights, loo,
                  launch_plan(m, means.shape[0], d, _sm_count(dev.index)),
                  diag)
    LAUNCHES += 1
    return out


def launch_with_plan(query: torch.Tensor, means: torch.Tensor,
                     var: torch.Tensor, weights: torch.Tensor, loo: bool,
                     plan: LaunchPlan, diag: int = 0) -> torch.Tensor:
    """:func:`tiled_log_eval` of CUDA tensors cut by ``plan`` (one of
    :func:`plans` for these shapes) instead of :func:`launch_plan`'s
    choice, and not counted in ``LAUNCHES``: it times the other plans."""
    _check(query, means, var, weights)
    _cuda_device(query, means, var, weights)
    return _launch(query, means, var, weights, loo, plan, diag)


def _cuda_device(*tensors: torch.Tensor) -> torch.device:
    """The one CUDA device of ``tensors``; raises unless they all lie on
    it, float32 and contiguous, with ``d <= MAX_DIM``."""
    dev = tensors[0].device
    if len({t.device for t in tensors}) != 1 or dev.type != "cuda":
        raise ValueError("tiled_log_eval: inputs must all lie on one CUDA "
                         f"device, got {[str(x.device) for x in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"tiled_log_eval: the kernel takes float32, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("tiled_log_eval: inputs must be contiguous")
    d = tensors[0].shape[1]
    if d > MAX_DIM:
        raise ValueError(f"tiled_log_eval: d={d} exceeds MAX_DIM={MAX_DIM}")
    return dev


def _launch(query, means, var, weights, loo, plan: LaunchPlan, diag=0):
    """One kernel launch of ``plan`` on the inputs' device and its current
    stream into a new ``[M]`` tensor; raises on a refused launch."""
    dev = query.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(query, means, var, weights, loo, plan, diag)
    m, d = query.shape
    n = means.shape[0]
    out = torch.empty((m,), dtype=torch.float32, device=dev)
    # the raw handle of torch.cuda.current_stream, without its Stream object
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rc = _load().kde_tiled_log_eval(
        query.data_ptr(), means.data_ptr(), var.data_ptr(),
        weights.data_ptr(), out.data_ptr(), m, n, d, int(bool(loo)),
        # an offset past either end skips nothing; clamped to fit a C int
        max(-m, min(n, int(diag))), plan.threads, plan.rows_per_thread,
        plan.splits, plan.per_split, stream)
    if rc != 0:
        raise RuntimeError(f"kde_tiled_log_eval launch failed: CUDA error {rc}")
    return out


def tiled_log_eval_ref(query: torch.Tensor, means: torch.Tensor,
                       var: torch.Tensor, weights: torch.Tensor,
                       loo: bool = False, diag: int = 0,
                       chunk: int = None) -> torch.Tensor:
    """Plain torch twin of :func:`tiled_log_eval`: the same math in any
    float dtype, chunked over queries so the live logits stay
    ``[chunk, N]`` (query ``m`` of a chunk starting at ``s`` skips column
    ``s + m + diag``)."""
    m, d = query.shape
    n = means.shape[0]
    if chunk is None:
        chunk = max(1, (1 << 22) // max(n, 1))
    hinv = 0.5 / var
    c = torch.log(weights) - 0.5 * torch.log(var).sum(dim=1)
    cols = torch.arange(n, device=query.device)
    out = []
    for s in range(0, m, chunk):
        qc = query[s:s + chunk]
        logits = c.expand(qc.shape[0], n).clone()
        for k in range(d):
            t = qc[:, k:k + 1] - means[None, :, k]
            logits -= t * t * hinv[None, :, k]
        if loo:
            rows = torch.arange(s + diag, s + diag + qc.shape[0],
                                device=query.device)
            logits.masked_fill_(rows[:, None] == cols[None, :], -math.inf)
        out.append(torch.logsumexp(logits, dim=1))
    if not out:
        return query.new_empty((0,))
    return torch.cat(out) - 0.5 * d * LOG_2PI
