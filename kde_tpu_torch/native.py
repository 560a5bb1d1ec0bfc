"""The native (C++) ball-tree builder (counterpart of ``kde_tpu/native``).

``csrc/balltree.cpp`` is compiled with g++ into ``kde_tpu_torch/_build/``
the first time a tree is built natively (never at import), and bound with
ctypes.  The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt; each process compiles to its own
temporary file and renames it into place, so concurrent builds (test
workers) do not collide.  A failed build raises with the compiler's output:
nothing falls back to the NumPy builder (``ops/balltree.py``,
``backend="python"``, the plain twin).

The flags keep the tree bit-identical to the NumPy builder:
``-ffp-contract=off`` stops GCC from fusing ``a*b+c`` (it does so by default
wherever the target has FMA: on aarch64 always, on x86 with ``-march``), and
a fused mean or variance in ``most_spread_dim`` can change a split
dimension and with it the whole tree.  No ``-march=native``, no
``-ffast-math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "balltree.cpp"
BUILD_DIR = _PKG / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off"]

# Trees built by the native builder; a run resets it to 0 and reads it to
# show which builder ran.
BUILDS = 0

_lib = None
_lock = threading.Lock()


def build() -> Path:
    """Compile ``csrc/balltree.cpp`` (once per source and flags) and return
    the shared library's path; raises ``RuntimeError`` with the compiler's
    output if the build fails."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join([CXX, *CXX_FLAGS]).encode()
                         ).hexdigest()[:16]
    out = BUILD_DIR / f"libballtree_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except OSError as e:
        raise RuntimeError(f"native ball-tree build failed: {' '.join(cmd)}"
                           f"\n{e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"native ball-tree build failed "
                           f"({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def get_lib():
    """The loaded library, built on first use, with its ctypes signatures
    set (``kde_build_balltree``, as in ``kde_tpu/native/__init__.py``)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64 = ctypes.c_int64
            dp = ctypes.POINTER(ctypes.c_double)
            ip = ctypes.POINTER(ctypes.c_int64)
            lib.kde_build_balltree.restype = None
            lib.kde_build_balltree.argtypes = [
                dp, dp, dp, i64, i64, ctypes.c_int,
                dp, dp, dp, ip, ip, ip, ip, ip, dp, dp, dp, dp, ip]
            _lib = lib
    return _lib
