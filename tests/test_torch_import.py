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
            "import kde_tpu_torch.functionals, kde_tpu_torch.serialization\n"
            "import kde_tpu_torch.manifolds, kde_tpu_torch.models.kernels\n"
            "import kde_tpu_torch.ops.sampling, kde_tpu_torch.ops.loocv\n"
            "import kde_tpu_torch.ops.host_small\n"
            "import kde_tpu_torch.utils.debug\n"
            "bad = [m for m in sys.modules if m in ('jax', 'kde_tpu') or "
            "m.startswith(('jax.', 'kde_tpu.'))]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = _run(code)
    assert res.returncode == 0, res.stdout + res.stderr


def test_parallel_import_leaves_jax_out():
    code = ("import sys, kde_tpu_torch.parallel\n"
            "bad = [m for m in sys.modules if m in ('jax', 'kde_tpu') or "
            "m.startswith(('jax.', 'kde_tpu.'))]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = _run(code)
    assert res.returncode == 0, res.stdout + res.stderr


def test_native_scaling_and_examples_import_leaves_jax_out_and_builds_nothing():
    twins = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT,
                                                           "examples_torch"))
                   if f.endswith(".py") and f != "__init__.py")
    assert len(twins) == 8
    code = ("import importlib, os, sys\n"
            "d = 'kde_tpu_torch/_build'\n"
            "before = sorted(os.listdir(d)) if os.path.isdir(d) else []\n"
            "import kde_tpu_torch, kde_tpu_torch.native\n"
            "import kde_tpu_torch.parallel.scaling_bench\n"
            f"for name in {twins!r}:\n"
            "    importlib.import_module('examples_torch.' + name)\n"
            "from kde_tpu_torch import native\n"
            "from kde_tpu_torch.ops import host_small, tiled_eval\n"
            "after = sorted(os.listdir(d)) if os.path.isdir(d) else []\n"
            "bad = [m for m in sys.modules if m in ('jax', 'kde_tpu') or "
            "m.startswith(('jax.', 'kde_tpu.'))]\n"
            "built = (native._lib, native.BUILDS, tiled_eval._lib,\n"
            "         tiled_eval.LAUNCHES, host_small._lib,\n"
            "         sum(host_small.LAUNCHES.values()), before != after)\n"
            "print(bad, built)\n"
            "sys.exit(1 if bad or built != (None, 0, None, 0, None, 0, False) "
            "else 0)\n")
    res = _run(code)
    assert res.returncode == 0, res.stdout + res.stderr


def test_parallel_exports_equal_jax():
    import kde_tpu.parallel
    import kde_tpu_torch.parallel
    assert kde_tpu_torch.parallel.__all__ == kde_tpu.parallel.__all__
    for name in kde_tpu_torch.parallel.__all__:
        assert hasattr(kde_tpu_torch.parallel, name), name


def test_csrc_sources_exist():
    from kde_tpu_torch.ops import host_small, tiled_eval
    assert tiled_eval.SOURCE.is_file()
    assert tiled_eval.SOURCE.parent.name == "csrc"
    text = tiled_eval.SOURCE.read_text()
    assert 'extern "C" int kde_tiled_log_eval' in text
    assert "compute_90a" in " ".join(tiled_eval.NVCC_FLAGS)
    assert "--fmad=false" not in tiled_eval.NVCC_FLAGS
    text = host_small.SOURCE.read_text()
    assert host_small.SOURCE.parent == tiled_eval.SOURCE.parent
    for entry in ("kde_loo_golden", "kde_small_log_eval"):
        assert f'extern "C" int {entry}' in text
    # the bracket arithmetic must not be contracted into FMAs
    assert "--fmad=false" in host_small.NVCC_FLAGS
    assert "compute_90a" in " ".join(host_small.NVCC_FLAGS)


def test_kernel_module_imports_without_nvcc():
    env = dict(os.environ, PATH="", CUDA_HOME="/nonexistent")
    code = ("import torch\n"
            "from kde_tpu_torch.ops import tiled_eval as t\n"
            "x = torch.zeros(4, 2)\n"
            "out = t.tiled_log_eval(x, x, torch.ones(4, 2), "
            "torch.full((4,), 0.25))\n"
            "assert t._lib is None and t.LAUNCHES == 0, (t._lib, t.LAUNCHES)\n"
            "assert out.shape == (4,)\n"
            "from kde_tpu_torch.ops import host_small as h\n"
            "x = torch.zeros(4, 1, dtype=torch.float64)\n"
            "w = torch.full((4,), 0.25, dtype=torch.float64)\n"
            "lp = h.log_eval_small(x, x, torch.ones_like(x), w)\n"
            "bw = h.ksize_small(torch.arange(4.0, dtype=torch.float64)[None],"
            " w)\n"
            "assert h._lib is None and sum(h.LAUNCHES.values()) == 0\n"
            "assert lp.shape == (4,) and bw.shape == (1,)\n")
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


def test_small_ops_off_the_cpu_never_take_the_plain_twins():
    """The same for the float64 small routes' wrappers: a meta tensor
    raises, and so do a wrong dtype and a wrong shape."""
    from kde_tpu_torch.ops import host_small
    f64 = torch.float64
    q = torch.zeros(4, 2, dtype=f64, device="meta")
    w = torch.full((4,), 0.25, dtype=f64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        host_small.log_eval_small(q, q, torch.ones_like(q), w)
    with pytest.raises(ValueError, match="CUDA"):
        host_small.loo_golden(q.T.contiguous(), w, *[torch.ones(
            2, dtype=f64, device="meta")] * 4, 1e-2)
    with pytest.raises(TypeError, match="float64"):
        host_small.log_eval_loo_small(torch.zeros(4, 2), torch.ones(4, 2),
                                      torch.full((4,), 0.25))
    with pytest.raises(ValueError, match="weights"):
        host_small.log_eval_small(torch.zeros(4, 2, dtype=f64),
                                  torch.zeros(3, 2, dtype=f64),
                                  torch.ones(3, 2, dtype=f64),
                                  torch.ones(4, dtype=f64))
