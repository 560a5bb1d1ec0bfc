"""The port imports torch and numpy, never JAX or the JAX package, and its
kernel module imports (and its wrapper routes) without a CUDA toolkit."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_import_leaves_jax_out():
    code = ("import sys, kde_tpu_torch, kde_tpu_torch.convert\n"
            "bad = [m for m in sys.modules if m in ('jax', 'kde_tpu') or "
            "m.startswith(('jax.', 'kde_tpu.'))]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = _run(code)
    assert res.returncode == 0, res.stdout + res.stderr


def test_csrc_sources_exist():
    from kde_tpu_torch.ops import tiled_eval
    assert tiled_eval.SOURCE.is_file()
    assert tiled_eval.SOURCE.parent.name == "csrc"
    text = tiled_eval.SOURCE.read_text()
    assert 'extern "C" int kde_tiled_log_eval' in text
    assert "compute_90a" in " ".join(tiled_eval.NVCC_FLAGS)


def test_kernel_module_imports_without_nvcc():
    env = dict(os.environ, PATH="", CUDA_HOME="/nonexistent")
    code = ("import torch\n"
            "from kde_tpu_torch.ops import tiled_eval as t\n"
            "x = torch.zeros(4, 2)\n"
            "out = t.tiled_log_eval(x, x, torch.ones(4, 2), "
            "torch.full((4,), 0.25))\n"
            "assert t._lib is None and t.LAUNCHES == 0, (t._lib, t.LAUNCHES)\n"
            "assert out.shape == (4,)\n")
    res = _run(code, env=env)
    assert res.returncode == 0, res.stdout + res.stderr


def test_non_cpu_tensor_never_takes_the_plain_twin():
    """A tensor off the CPU goes to the kernel or raises; here (no card)
    a meta tensor must raise instead of falling back."""
    from kde_tpu_torch.ops import tiled_eval
    q = torch.zeros(4, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tiled_eval.tiled_log_eval(q, q, torch.ones(4, 2, device="meta"),
                                  torch.ones(4, device="meta"))
    with pytest.raises(ValueError, match="weights"):
        tiled_eval.tiled_log_eval(torch.zeros(4, 2), torch.zeros(3, 2),
                                  torch.ones(3, 2), torch.ones(4))
