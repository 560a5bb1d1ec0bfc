"""Tiled weighted log-sum-exp Gaussian-mixture evaluation (ports
``kde_tpu/ops/pallas_eval.py``, the TPU kernel K1).

``tiled_log_eval`` launches the hand-written CUDA kernel
``csrc/tiled_eval.cu`` for CUDA tensors and takes the plain twin
``tiled_log_eval_ref`` for CPU tensors.  Both compute

    out[m] = log sum_n w_n prod_k N(q_mk; mu_nk, var_nk)

with the direct ``(q - mu)^2 / var + log var`` form, never materializing the
``[M, N]`` logits in device memory.  With ``loo``, component ``m`` is
left out of query ``m`` and the caller applies the ``-log1p(-w)`` rescale.

The kernel is built with ``nvcc`` into ``kde_tpu_torch/_build/`` the first
time it is launched, and loaded with ``ctypes``.  A failed build raises
with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

LOG_2PI = math.log(2.0 * math.pi)

# Launches of the CUDA kernel; a run resets it to 0 and reads it to show the
# main path went through the kernel.
LAUNCHES = 0

MAX_DIM = 16                  # kMaxDim in csrc/tiled_eval.cu

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "tiled_eval.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_QUERIES_PER_BLOCK = 128      # kThreads in csrc/tiled_eval.cu
_TILE = 256                   # kTile in csrc/tiled_eval.cu
_BLOCKS_PER_SM = 8

_lib = None
BUILD_LOG = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernel of tiled_log_eval "
                       "is built with the CUDA toolkit's nvcc")


def build() -> Path:
    """Compile ``csrc/tiled_eval.cu`` (once per source content) and return
    the shared library's path."""
    global BUILD_LOG
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libtiled_eval_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{BUILD_LOG}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.kde_tiled_log_eval
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _splits(m: int, n: int, device) -> int:
    """Component-axis splits: enough blocks to fill the card's SMs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks_m = -(-m // _QUERIES_PER_BLOCK)
    want = max(1, (sms * _BLOCKS_PER_SM) // max(blocks_m, 1))
    return max(1, min(want, -(-n // _TILE), 64))


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
                   loo: bool = False) -> torch.Tensor:
    """``log p`` of the mixture at each query row (``[M, d]`` queries,
    ``[N, d]`` means and variances, ``[N]`` weights) -> ``[M]``.

    CPU tensors take :func:`tiled_log_eval_ref`.  CUDA tensors launch the
    kernel; they must all be float32, contiguous and on one device, with
    ``d <= MAX_DIM``, or this raises."""
    global LAUNCHES
    _check(query, means, var, weights)
    tensors = (query, means, var, weights)
    if all(t.device.type == "cpu" for t in tensors):
        return tiled_log_eval_ref(query, means, var, weights, loo)
    dev = query.device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("tiled_log_eval: inputs must all lie on one "
                             f"CUDA device, got {[str(x.device) for x in tensors]}")
        if t.dtype != torch.float32:
            raise TypeError(f"tiled_log_eval: the kernel takes float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("tiled_log_eval: inputs must be contiguous")
    m, d = query.shape
    n = means.shape[0]
    if d > MAX_DIM:
        raise ValueError(f"tiled_log_eval: d={d} exceeds MAX_DIM={MAX_DIM}")
    lib = _load()
    hinv = (0.5 / var).contiguous()
    c = (torch.log(weights) - 0.5 * torch.log(var).sum(dim=1)).contiguous()
    splits = _splits(m, n, dev)
    part = torch.empty((2, splits, m), dtype=torch.float32, device=dev)
    out = torch.empty((m,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.kde_tiled_log_eval(
            query.data_ptr(), means.data_ptr(), hinv.data_ptr(),
            c.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            out.data_ptr(), m, n, d, int(bool(loo)), splits, stream)
    if rc != 0:
        raise RuntimeError(f"kde_tiled_log_eval launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def tiled_log_eval_ref(query: torch.Tensor, means: torch.Tensor,
                       var: torch.Tensor, weights: torch.Tensor,
                       loo: bool = False, chunk: int = None) -> torch.Tensor:
    """Plain torch twin of :func:`tiled_log_eval`: the same math in any
    float dtype, chunked over queries so the live logits stay
    ``[chunk, N]``."""
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
            rows = torch.arange(s, s + qc.shape[0], device=query.device)
            logits.masked_fill_(rows[:, None] == cols[None, :], -math.inf)
        out.append(torch.logsumexp(logits, dim=1))
    if not out:
        return query.new_empty((0,))
    return torch.cat(out) - 0.5 * d * LOG_2PI
