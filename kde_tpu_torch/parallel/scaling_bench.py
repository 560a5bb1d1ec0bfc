"""Scaling harness of the sharded Gibbs products (counterpart of
``kde_tpu/parallel/scaling_bench.py``).

Measures the chain-sharded product's samples/s on worlds of 1..N ranks
under both scaling disciplines, and counts the kernel-sharded engine's
communication:

* **strong scaling**: fixed total chains, split across ranks;
* **weak scaling**: fixed chains per rank, the total grows with the ranks;
* :func:`comm_table`: the collectives of the kernel-sharded engine
  (``gibbs_kernel_sharded.py``) per label selection and per product, with
  their bytes.

A mesh spans the whole world (``mesh.py``), so :func:`run` starts one world
of child processes per size, one rank per card (NCCL), or CPU processes
over gloo when ``config.DEVICE`` is ``"cpu"`` (those share one host's
cores: the efficiency columns then validate the harness and measure
nothing).  On a host with N cards::

    python -m kde_tpu_torch.parallel.scaling_bench --out scaling.json

It writes a file only to an explicit ``out_path`` (``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from .. import config
from ..ops import gibbs as _g
from ..ops.balltree import level_lists, n_levels, topology
from .gibbs_kernel_sharded import _route as _ks_route
from .mesh import pad_to_multiple

SIZES = (1, 2, 4, 8, 16, 32, 64)
WORKER_TIMEOUT = 600          # seconds: one world, and every collective
_ROOT = Path(__file__).resolve().parents[2]


def comm_table(n_out: int, n_comp: int, ndens: int, n_iter: int,
               shards: int, d: int = 2, dtype=torch.float32,
               device=None) -> dict:
    """The collectives of one kernel-sharded product of ``ndens``
    ``n_comp``-component ``d``-dim Euclidean densities with ``n_out``
    chains over ``shards`` ranks of ``kernels`` (``gibbs_kernel_sharded.
    py``) whose densities lie on ``device`` (default ``config.DEVICE``),
    and the bytes each rank receives from them.

    One label selection issues six: ``pmax``, ``psum`` (the degenerate
    test), ``pmax`` (the global max), an ``all_gather`` of the ``[S]``
    float64 shard totals, an integer ``psum`` of the index and a float64
    ``psum`` of the winner's ``[2d+1]`` stats
    (``gibbs_kernel_sharded._sharded_choose``).  A chain selects ``ndens * L * (1 + n_iter)``
    times: the initial selection is every tree's root, which needs none,
    where ``kde_tpu``'s table counts ``ndens * (1 + L * (1 + n_iter))``.
    The conditioning step selects all densities in one batch of six calls,
    and the chains run in blocks (``ops/gibbs.py::_chain_block``) sized
    for the selection's route: one block on the card's kernels (K6 keeps
    no ``[chains, width]`` temporary), blocks of ``_LIVE_TEMPS`` such
    temporaries on the twins; so a product makes ``6 * blocks * L * (1 +
    n_iter * ndens)`` calls."""
    L = n_levels(n_out, [n_comp] * ndens)
    topo = topology(n_comp)
    widths = [len(lv) for lv in
              level_lists(topo.left, topo.right, n_comp, L)[1:]]
    w_loc = max(pad_to_multiple(max(w, 1), shards) // shards
                for w in widths)
    itemsize = torch.empty((), dtype=dtype).element_size()
    route = _ks_route(None, config.default_device(device), d)
    block = _g._chains_per_block(n_out, w_loc, itemsize,
                                 _g._live_temps(route))
    blocks = -(-n_out // block)
    per_selection = [
        ("pmax", "degenerate test: the largest logit", itemsize),
        ("psum", "degenerate test: the shifted exp-sum", itemsize),
        ("pmax", "the global max", itemsize),
        ("all_gather", "the [S] float64 shard totals", 8 * shards),
        ("psum", "the int64 index: CDF entries below u", 8),
        ("psum", "the winner's [2d+1] float64 stats", 8 * (2 * d + 1)),
    ]
    bytes_per_sel = sum(b for _, _, b in per_selection)
    sel_per_chain = ndens * L * (1 + n_iter)
    return {
        "collectives_per_selection": [
            {"op": op, "what": what, "bytes_per_chain": b}
            for op, what, b in per_selection],
        "selections_per_chain": sel_per_chain,
        "route": route,
        "bytes_per_selection_per_device": bytes_per_sel,
        "chain_blocks": blocks,
        "collective_calls_per_product":
            len(per_selection) * blocks * L * (1 + n_iter * ndens),
        "total_bytes_per_product": n_out * sel_per_chain * bytes_per_sel,
        "note": ("bytes each rank receives (an all_gather returns S times "
                 "what it sends); O(S) values a selection and chain, so "
                 "per-call latency, not volume, bounds the engine"),
    }


def rate(mesh, densities, chains: int, n_iter: int, reps: int = 5) -> float:
    """Samples/s of ``prod_appx_ms_gibbs_sharded`` with ``chains`` chains:
    one warm-up call, then ``reps`` keyed calls in one window that ends in
    ``torch.cuda.synchronize()`` on the card (a gloo CPU world needs no
    fence: its results are on the host)."""
    from .product import prod_appx_ms_gibbs_sharded
    on_card = densities[0].device.type == "cuda"
    fence = torch.cuda.synchronize if on_card else (lambda: None)
    prod_appx_ms_gibbs_sharded(mesh, chains, densities, n_iter=n_iter,
                               key=0)
    fence()
    t0 = time.perf_counter()
    for r in range(reps):
        prod_appx_ms_gibbs_sharded(mesh, chains, densities, n_iter=n_iter,
                                   key=r + 1)
    fence()
    return chains * reps / (time.perf_counter() - t0)


def _world_rank(rank: int, world: int, url: str, cfg: dict) -> None:
    """One rank of a world: both rates on the whole-world mesh; rank 0
    prints them as its last line."""
    import torch.distributed as dist
    from ..density import kde
    from .mesh import make_mesh
    from .product import initialize_multihost
    on_card = cfg["device"] == "cuda"
    initialize_multihost(url, world, rank,
                         backend="nccl" if on_card else "gloo",
                         timeout=cfg["timeout"])
    try:
        dev = (torch.device("cuda", torch.cuda.current_device()) if on_card
               else torch.device("cpu"))
        rng = np.random.default_rng(0)
        dens = [kde(rng.normal(size=(2, cfg["n_comp"])), [0.1], device=dev,
                    dtype=torch.float32) for _ in range(2)]
        for p in dens:
            p.tree
        mesh = make_mesh()
        out = {"strong": rate(mesh, dens, cfg["total_chains"],
                              cfg["n_iter"]),
               "weak": rate(mesh, dens, cfg["per_device"] * world,
                            cfg["n_iter"])}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(out), flush=True)


def _run_world(world: int, url: str, cfg: dict, timeout: float) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kde_tpu_torch.parallel.scaling_bench",
         "--worker", str(r), str(world), url, json.dumps(cfg)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, text) in enumerate(zip(procs, outs)):
        if proc.returncode != 0:
            raise RuntimeError(f"scaling world of {world}: rank {r} exited "
                               f"{proc.returncode}:\n{text[-4000:]}")
    return json.loads(outs[0].strip().splitlines()[-1])


def run(sizes: Optional[Sequence[int]] = None, total_chains: int = 4096,
        n_comp: int = 1000, n_iter: int = 5,
        out_path: Optional[str] = None,
        timeout: float = WORKER_TIMEOUT) -> dict:
    """Strong and weak scaling of the chain-sharded product over two
    ``n_comp``-component 2-D densities, one world per size in ``sizes``
    (default: every power of two up to the visible cards), and
    :func:`comm_table` at the largest size, on ``config.DEVICE``:
    ``"cuda"`` (one card per rank, NCCL) or ``"cpu"`` (gloo).  Efficiency
    is against linear scaling from the smallest size.  Returns
    ``kde_tpu``'s result layout, and writes it as JSON only to
    ``out_path``."""
    kind = config.default_device().type
    n_dev = torch.cuda.device_count() if kind == "cuda" else os.cpu_count()
    if sizes is None:
        sizes = [s for s in SIZES if s <= (n_dev if kind == "cuda" else 1)]
    sizes = sorted(int(s) for s in sizes)
    if not sizes or sizes[0] < 1 or (kind == "cuda" and sizes[-1] > n_dev):
        raise ValueError(f"sizes {sizes}: each world needs one {kind} "
                         f"device per rank, and {n_dev} are visible")
    cfg = {"device": kind, "total_chains": int(total_chains),
           "per_device": int(total_chains) // sizes[-1],
           "n_comp": int(n_comp), "n_iter": int(n_iter),
           "timeout": float(timeout)}
    strong, weak = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for s in sizes:
            r = _run_world(s, f"file://{tmp}/store{s}", cfg, timeout)
            strong.append({"devices": s, "samples_per_s": r["strong"]})
            weak.append({"devices": s, "samples_per_s": r["weak"]})
            print(f"devices={s}: strong {r['strong']:,.0f} samples/s, "
                  f"weak {r['weak']:,.0f} samples/s", flush=True)
    for rows in (strong, weak):
        base = rows[0]["samples_per_s"] / rows[0]["devices"]
        for row in rows:
            row["efficiency"] = row["samples_per_s"] / (base * row["devices"])
    result = {
        "date": time.strftime("%Y-%m-%d"),
        "backend": "nccl" if kind == "cuda" else "gloo",
        "device": (torch.cuda.get_device_name(0) if kind == "cuda"
                   else "cpu"),
        "devices_available": n_dev,
        "virtual_cpu_mesh": kind == "cpu",
        "config": {"total_chains": int(total_chains), "n_comp": int(n_comp),
                   "ndens": 2, "ndim": 2, "n_iter": int(n_iter),
                   "sizes": sizes},
        "strong_scaling": strong,
        "weak_scaling": weak,
        "kernel_sharded_comm": comm_table(int(total_chains), int(n_comp), 2,
                                          int(n_iter), shards=sizes[-1],
                                          device=kind),
        "procedure": ("python -m kde_tpu_torch.parallel.scaling_bench "
                      "[--sizes 1,2,4] [--out FILE]: one world of child "
                      "processes per size, one card per rank"),
        "caveat": ("gloo CPU ranks share one host's cores: the efficiency "
                   "columns validate the harness only" if kind == "cpu"
                   else None),
    }
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {out_path}", flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m kde_tpu_torch.parallel.scaling_bench",
        description="Strong/weak scaling of the chain-sharded Gibbs "
                    "product and the kernel-sharded engine's comm table.")
    ap.add_argument("--sizes", help="comma-separated world sizes "
                    "(default: powers of two up to the visible cards)")
    ap.add_argument("--chains", type=int, default=4096)
    ap.add_argument("--comp", type=int, default=1000)
    ap.add_argument("--iter", type=int, default=5)
    ap.add_argument("--out", help="write the result as JSON here")
    args = ap.parse_args(argv)
    sizes = ([int(s) for s in args.sizes.split(",")] if args.sizes
             else None)
    res = run(sizes, args.chains, args.comp, args.iter, args.out)
    print(json.dumps(res))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _world_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                    json.loads(sys.argv[5]))
    else:
        main()
