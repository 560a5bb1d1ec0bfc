"""Multi-process ``torch.distributed`` worlds for the port's sharded tests
(not a test).

A test file that needs a world is also its own worker script:
``python tests/test_torch_<x>.py --worker <rank> <world> <store> <out>``.
:func:`run_world` starts the ranks, each a torch-only process (JAX is never
imported there), and waits for all of them under one time limit; every
rank writes ``rank<r>.npz`` of its results into ``<out>``.  A rank that
fails or hangs fails the test: the process group's timeout turns a missing
peer into an error, and the limit kills what is left.
"""
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PG_TIMEOUT = 60          # seconds a collective waits for a missing peer


def run_world(script, out_dir, world=4, timeout=240, args=(), env=None):
    """Run ``world`` ranks of ``script`` in worker mode, rendezvous on a
    file store in ``out_dir`` (no TCP port to race for under xdist), and
    return every rank's results as a list of dicts."""
    out_dir = str(out_dir)
    store = os.path.join(out_dir, "store")
    base = dict(os.environ, OMP_NUM_THREADS="1")
    base.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, script, "--worker", str(r), str(world),
         "file://" + store, out_dir, *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=base, cwd=ROOT) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline
                                               - time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
    results = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
            results.append({k: f[k] for k in f.files})
    return results


def worker_setup(argv):
    """Parse the worker arguments, join the world over gloo, and return
    ``(rank, out_dir)``."""
    rank, world, url, out_dir = (int(argv[2]), int(argv[3]), argv[4],
                                 argv[5])
    sys.path.insert(0, ROOT)
    import torch
    torch.set_num_threads(1)
    from kde_tpu_torch.parallel import initialize_multihost
    initialize_multihost(url, world, rank, backend="gloo",
                         timeout=PG_TIMEOUT)
    return rank, out_dir


def worker_finish(rank, out_dir, results):
    """Write this rank's results and leave the world."""
    import torch.distributed as dist
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in results.items()})
    dist.barrier()
    dist.destroy_process_group()


def assert_replicated(results, keys=None):
    """Every rank returned bitwise the same arrays (outputs are gathered,
    and the loops around the collectives branch on replicated values)."""
    for k in keys or results[0]:
        for r, res in enumerate(results[1:], 1):
            np.testing.assert_array_equal(res[k], results[0][k],
                                          err_msg=f"{k}: rank {r} != rank 0")
