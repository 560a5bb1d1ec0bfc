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


def test_tools_import_leaves_jax_out_and_builds_nothing():
    """The accelerator tools of ``tools_torch/`` import torch, numpy and
    the port only, and importing them runs, builds and launches
    nothing."""
    code = ("import os, sys\n"
            "d = 'kde_tpu_torch/_build'\n"
            "before = sorted(os.listdir(d)) if os.path.isdir(d) else []\n"
            "import tools_torch.validate_cuda, tools_torch.scale_envelope\n"
            "from kde_tpu_torch.ops import gibbs_chain\n"
            "after = sorted(os.listdir(d)) if os.path.isdir(d) else []\n"
            "bad = [m for m in sys.modules if m in ('jax', 'kde_tpu') or "
            "m.startswith(('jax.', 'kde_tpu.'))]\n"
            "print(bad, gibbs_chain._lib, gibbs_chain.LAUNCHES)\n"
            "sys.exit(1 if bad or before != after or gibbs_chain._lib\n"
            "         or gibbs_chain.LAUNCHES else 0)\n")
    res = _run(code)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sharded_select_imports_and_runs_its_twins_without_nvcc():
    """The kernel-sharded selection (K6) imports torch only, and on CPU
    tensors a kernel-sharded product runs its twins without a toolkit:
    nothing built, nothing launched, every stage counted as a twin's."""
    env = dict(os.environ, PATH="", CUDA_HOME="/nonexistent")
    code = ("import os, sys, tempfile\n"
            "import numpy as np, torch\n"
            "import kde_tpu_torch as kt\n"
            "from kde_tpu_torch import parallel as par\n"
            "from kde_tpu_torch.ops import sharded_select as ss\n"
            "kt.config.DEVICE = 'cpu'\n"
            "store = os.path.join(tempfile.mkdtemp(), 'store')\n"
            "par.initialize_multihost('file://' + store, 1, 0, "
            "backend='gloo', timeout=60)\n"
            "rng = np.random.default_rng(0)\n"
            "dens = [kt.kde(rng.normal(size=(2, 40)), [0.3]) "
            "for _ in range(2)]\n"
            "pts, idx = par.prod_appx_ms_gibbs_kernel_sharded(\n"
            "    par.make_mesh_2d((1, 1)), 6, dens, n_iter=1, key=0)\n"
            "torch.distributed.destroy_process_group()\n"
            "bad = [m for m in sys.modules if m in ('jax', 'kde_tpu') or "
            "m.startswith(('jax.', 'kde_tpu.'))]\n"
            "print(bad, ss._lib, ss.LAUNCHES, ss.TWIN_STAGES)\n"
            "sys.exit(1 if bad or ss._lib is not None or ss.LAUNCHES\n"
            "         or ss.TWIN_STAGES < 1 or idx.shape != (2, 6) else 0)\n")
    res = _run(code, env=env)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sharded_select_source_and_shared_header():
    """K6's source, its entries and flags; it and K2 include the one
    header that holds the candidate logit, which the build hash covers."""
    from kde_tpu_torch.ops import gibbs_select, sharded_select, tiled_eval
    text = sharded_select.SOURCE.read_text()
    assert sharded_select.SOURCE.parent == tiled_eval.SOURCE.parent
    for entry in ("kde_k6_phase", "kde_k6_stage_bytes", "kde_k6_dead_max",
                  "kde_k6_owner_stats"):
        assert f'extern "C" int {entry}' in text
    assert 'extern "C" long long kde_k6_smem' in text
    assert "--fmad=false" in sharded_select.NVCC_FLAGS
    assert "compute_90a" in " ".join(sharded_select.NVCC_FLAGS)
    header = sharded_select.SOURCE.parent / "gibbs_logit.cuh"
    for src in (sharded_select.SOURCE, gibbs_select.SOURCE):
        assert '#include "gibbs_logit.cuh"' in src.read_text()
        assert header.read_bytes() in tiled_eval.source_bytes(src)
    assert "candidate_logit" in header.read_text()
    assert "row_logit" in header.read_text() and "row_logit" in text


def test_sharded_loo_imports_and_runs_its_twins_without_nvcc():
    """The sharded LOOCV search (K7) imports torch only, and on CPU tensors
    ksize_bandwidths_sharded runs its twins without a toolkit: nothing
    built, nothing launched, every launch counted as a twin's (stage,
    nn_shift, one a sweep and the closing step)."""
    env = dict(os.environ, PATH="", CUDA_HOME="/nonexistent")
    code = ("import os, sys, tempfile\n"
            "import numpy as np, torch\n"
            "import kde_tpu_torch as kt\n"
            "from kde_tpu_torch import parallel as par\n"
            "from kde_tpu_torch.ops import sharded_loo as sl\n"
            "kt.config.DEVICE = 'cpu'\n"
            "store = os.path.join(tempfile.mkdtemp(), 'store')\n"
            "par.initialize_multihost('file://' + store, 1, 0, "
            "backend='gloo', timeout=60)\n"
            "pts = np.random.default_rng(0).normal(size=(50, 2))\n"
            "bw = par.ksize_bandwidths_sharded(par.make_mesh_2d((1, 1)), "
            "pts)\n"
            "torch.distributed.destroy_process_group()\n"
            "bad = [m for m in sys.modules if m in ('jax', 'kde_tpu') or "
            "m.startswith(('jax.', 'kde_tpu.'))]\n"
            "print(bad, sl._lib, sl.LAUNCHES, sl.TWIN_STAGES)\n"
            "sys.exit(1 if bad or sl._lib is not None or sl.LAUNCHES\n"
            "         or sl.TWIN_STAGES != 3 + sl.LAST['sweeps']\n"
            "         or bw.shape != (2,) else 0)\n")
    res = _run(code, env=env)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sharded_loo_source_and_shared_header():
    """K7's source, its entries and flags; it and K4 include the one header
    that holds the probe arithmetic, which the build hash covers."""
    from kde_tpu_torch.ops import loo_search, sharded_loo, tiled_eval
    text = sharded_loo.SOURCE.read_text()
    assert sharded_loo.SOURCE.parent == tiled_eval.SOURCE.parent
    for entry in ("kde_k7_stage", "kde_k7_nn_shift", "kde_k7_sweep",
                  "kde_k7_golden_step"):
        assert f'extern "C" int {entry}' in text
    assert "--fmad=false" in sharded_loo.NVCC_FLAGS
    assert "compute_90a" in " ".join(sharded_loo.NVCC_FLAGS)
    header = sharded_loo.SOURCE.parent / "loo_probe.cuh"
    for src in (sharded_loo.SOURCE, loo_search.SOURCE):
        assert '#include "loo_probe.cuh"' in src.read_text()
        assert header.read_bytes() in tiled_eval.source_bytes(src)
    assert "pair_term" in header.read_text()


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
    with pytest.raises(ValueError, match="CUDA"):
        host_small.ksize_small(q.T.contiguous(), w)
    with pytest.raises(TypeError, match="float64"):
        host_small.log_eval_loo_small(torch.zeros(4, 2), torch.ones(4, 2),
                                      torch.full((4,), 0.25))
    with pytest.raises(ValueError, match="weights"):
        host_small.log_eval_small(torch.zeros(4, 2, dtype=f64),
                                  torch.zeros(3, 2, dtype=f64),
                                  torch.ones(3, 2, dtype=f64),
                                  torch.ones(4, dtype=f64))
