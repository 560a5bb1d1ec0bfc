"""The plain Gibbs product engine's memory and time along N on the card:
the counterpart of ``tools/scale_envelope.py`` on ``kde_tpu_torch``.

Every stage draws from two device-resident N-component 2-D densities at
bandwidth 0.1 (:func:`_dens`, as ``tools/scale_envelope.py:50-57``), 256
chains, Niter 5:

  mem      the allocator's peak of one keyed product, its plan built fresh
           inside the window (topology upload, device tree statistics,
           level plan, streams, the draw), over N x {cdf, gumbel}, beside
           ``parallel.estimate_product_memory``'s args, temp, out and
           total and their ratio to the peak; an out-of-memory error is a
           recorded row;
  time     ms per call and samples/s of cdf, blocked and gumbel at N =
           100k, 200k, 400k: the arms in turns, a distinct seed each call,
           one call a window ending in ``torch.cuda.synchronize()``, best
           of 6 rounds; the N at which a mode overtakes cdf, if one does;
  sharded  the kernel-sharded engine at S = 1 in a one-rank NCCL world
           against the plain engine at 50k, in turns, best of 6;
  rule     peak ~= c0 + c1 * chains * N_total and the plan's bytes per
           component, fitted from the mem rows beside the same fits of the
           estimate, and the smallest N at which ``recommend_shards``
           returns 2 shards under the default budget (0.75 of the card's
           memory): extrapolated from the estimate, not run.

    python3 -m tools_torch.scale_envelope [mem|time|sharded|rule|all]
                                          [--out FILE]

Each stage prints one JSON line (with the card's name and power limit);
``--out`` also writes them to FILE.  ``all`` runs mem, time and sharded,
then rule on mem's rows.  The stages run on the card unless a caller
passes ``device="cpu"``; without a card they raise.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

import kde_tpu_torch as kt
from kde_tpu_torch.ops import (device_plan, gibbs, gibbs_chain, gibbs_select,
                               sharded_select)
from kde_tpu_torch.parallel import sizing

from . import card_line, free_port, resolve_device, sync

N_OUT = 256
N_ITER = 5
D = 2
BW = 0.1
NS = (50_000, 100_000, 200_000, 400_000, 800_000)
TIME_NS = (100_000, 200_000, 400_000)
SELECTS = ("cdf", "blocked", "gumbel")
ROUNDS = 6
WORLD_TIMEOUT = 600      # seconds a collective of the sharded stage waits


def _dens(n: int, device, seed: int = 0):
    """Two device-resident N-component 2-D densities, N(0, I) and
    N(0.5, I), at bandwidth 0.1 (their plans are built on the device)."""
    rng = np.random.default_rng(seed)
    pts = lambda s: torch.as_tensor(rng.normal(size=(D, n)) + s,
                                    dtype=torch.float32, device=device)
    return [kt.kde(pts(0.0), [BW]), kt.kde(pts(0.5), [BW])]


def _product(dens, select, key):
    return kt.prod_appx_ms_gibbs(N_OUT, dens, n_iter=N_ITER, key=key,
                                 select=select)


def peak_bytes(fn, device) -> int:
    """The allocator's peak while ``fn()`` runs, above what was allocated
    before it."""
    sync(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    sync(device)
    return torch.cuda.max_memory_allocated(device) - base


def plan_bytes(dens) -> int:
    """Bytes of the level plan cached for ``dens``: its tensors and
    uniform-level flags."""
    ids = tuple(id(p) for p in dens)
    plan = next(v for k, v in gibbs._plan_cache.items() if k[0] == ids)
    return (sum(getattr(plan, f).nbytes for f in gibbs._PLAN_TENSORS)
            + plan.lvl_uniform.nbytes)


def mem_row(n: int, select: str, device) -> dict:
    """One keyed product of fresh densities at N with the topology cache
    emptied, so the window holds the whole build; the estimate's columns
    beside the peak."""
    dens = _dens(n, device)
    device_plan._topology_on.cache_clear()
    est = sizing.estimate_product_memory(dens, N_OUT, n_iter=N_ITER,
                                         dtype=torch.float32, select=select)
    row = dict(N=n, select=select, **{k: est[k] for k in
                                      ("args", "temp", "out", "total")})
    try:
        row["peak"] = peak_bytes(lambda: _product(dens, select, 0), device)
    except torch.cuda.OutOfMemoryError as e:
        row["error"] = f"{type(e).__name__}: {str(e)[:200]}"
        torch.cuda.empty_cache()
        return row
    row["plan"] = plan_bytes(dens)
    row["ratio"] = row["total"] / row["peak"]
    return row


def mem_stage(ns: Sequence[int] = NS, selects=("cdf", "gumbel"),
              device=None) -> dict:
    device = resolve_device(device)
    rows = [mem_row(n, s, device) for n in ns for s in selects]
    return {"stage": "mem", "card": card_line(device), "chains": N_OUT,
            "rows": rows}


def time_stage(ns: Sequence[int] = TIME_NS, selects=SELECTS,
               rounds: int = ROUNDS, device=None) -> dict:
    """Arms (N, select) in turns, one call a window, best of ``rounds``."""
    device = resolve_device(device)
    dens = {n: _dens(n, device) for n in ns}
    arms, rows = [], []
    for n in ns:
        for s in selects:
            k3, k2 = gibbs_chain.LAUNCHES, gibbs_select.LAUNCHES
            try:
                _product(dens[n], s, 0)
                sync(device)
            except torch.cuda.OutOfMemoryError as e:
                rows.append(dict(N=n, select=s, error=str(e)[:200]))
                torch.cuda.empty_cache()
                continue
            arms.append((n, s))
            rows.append(dict(N=n, select=s,
                             k3_launches=gibbs_chain.LAUNCHES - k3,
                             k2_launches=gibbs_select.LAUNCHES - k2))
    best = {a: float("inf") for a in arms}
    for r in range(rounds):
        for i, (n, s) in enumerate(arms):
            sync(device)
            t0 = time.perf_counter()
            _product(dens[n], s, 1000 * r + i + 1)
            sync(device)
            best[(n, s)] = min(best[(n, s)], time.perf_counter() - t0)
    for row in rows:
        if "error" not in row:
            sec = best[(row["N"], row["select"])]
            row.update(ms=1e3 * sec, samples_per_s=N_OUT / sec)
    return {"stage": "time", "card": card_line(device), "chains": N_OUT,
            "rounds": rounds, "rows": rows,
            "overtakes_cdf": crossover(rows)}


def crossover(rows) -> dict:
    """Per mode other than cdf, the smallest N at which its samples/s
    beat cdf's (None if it never does)."""
    rate = {(r["N"], r["select"]): r["samples_per_s"] for r in rows
            if "samples_per_s" in r}
    out = {}
    for s in sorted({s for _, s in rate} - {"cdf"}):
        wins = [n for (n, t) in rate if t == s and (n, "cdf") in rate
                and rate[(n, s)] > rate[(n, "cdf")]]
        out[s] = min(wins) if wins else None
    return out


def sharded_stage(ns: Sequence[int] = (50_000,), rounds: int = ROUNDS,
                  device=None) -> dict:
    """The kernel-sharded engine at S = 1 (NCCL on the card, gloo on the
    CPU) against the plain engine, keyed, in turns; with the selections'
    K6 launches and twin stages of the sharded arm's timed calls."""
    import torch.distributed as dist
    from kde_tpu_torch import parallel as par
    device = resolve_device(device)
    par.initialize_multihost(
        f"127.0.0.1:{free_port()}", 1, 0, timeout=WORLD_TIMEOUT,
        backend="nccl" if device.type == "cuda" else "gloo")
    rows = []
    try:
        mesh = par.make_mesh(axis_name=par.KERNELS)
        for n in ns:
            dens = _dens(n, device)
            arms = {"plain": lambda k: _product(dens, "cdf", k),
                    "sharded": lambda k: (
                        par.prod_appx_ms_gibbs_kernel_sharded(
                            mesh, N_OUT, dens, n_iter=N_ITER, key=k))}
            best = {}
            for a, f in arms.items():
                f(0)
                best[a] = float("inf")
            k6, twin = sharded_select.LAUNCHES, sharded_select.TWIN_STAGES
            for r in range(rounds):
                order = list(arms) if r % 2 == 0 else list(arms)[::-1]
                for i, a in enumerate(order):
                    sync(device)
                    t0 = time.perf_counter()
                    arms[a](1000 * r + i + 1)
                    sync(device)
                    best[a] = min(best[a], time.perf_counter() - t0)
            rows.append(dict(N=n, plain_ms=1e3 * best["plain"],
                             sharded_ms=1e3 * best["sharded"],
                             ratio=best["sharded"] / best["plain"],
                             k6_launches=sharded_select.LAUNCHES - k6,
                             k6_twin_stages=(sharded_select.TWIN_STAGES
                                             - twin)))
    finally:
        dist.destroy_process_group()
    return {"stage": "sharded", "card": card_line(device), "chains": N_OUT,
            "shards": 1, "rounds": rounds, "rows": rows}


def fit_rule(rows) -> dict:
    """From mem rows (cdf, no error): ``peak ~= c0 + c1 * chains *
    N_total`` and the plan's bytes per component, with the same fits of
    the estimate's total and args beside them."""
    rows = sorted((r for r in rows if r.get("select") == "cdf"
                   and "peak" in r), key=lambda r: r["N"])
    if len(rows) < 2:
        raise ValueError(f"the rule needs two cdf rows of the mem stage, "
                         f"got {len(rows)}")
    x = np.array([N_OUT * 2.0 * r["N"] for r in rows])
    per_comp = lambda k: ((rows[-1][k] - rows[0][k])
                          / (2.0 * (rows[-1]["N"] - rows[0]["N"])))
    c1, c0 = np.polyfit(x, [float(r["peak"]) for r in rows], 1)
    m1, m0 = np.polyfit(x, [float(r["total"]) for r in rows], 1)
    return dict(c0=float(c0), c1=float(c1), plan_per_component=per_comp(
        "plan"), model_c0=float(m0), model_c1=float(m1),
        model_args_per_component=per_comp("args"))


def fit_budget_n(fit: dict, budget: int) -> int:
    """The N (per density, 2 densities) at which the fitted peak line
    reaches ``budget``."""
    return int(np.ceil((budget - fit["c0"]) / (fit["c1"] * N_OUT * 2.0)))


def two_shard_n(device, budget: Optional[int] = None, hi: int = 1 << 40):
    """The smallest N (2 densities, 2-D, 256 chains, plan built on the
    card) at which ``recommend_shards`` returns 2 shards under ``budget``
    (default: the card's, ``sizing.default_hbm_budget``), from the
    estimate alone; with ``recommend_shards`` at that N and the one
    below."""
    if budget is None:
        budget = sizing.default_hbm_budget(device)

    def rule(n):
        mem = sizing.product_bytes((n, n), D, N_OUT, N_ITER, torch.float32,
                                   "auto", "device", device)
        return sizing.recommend_shards([], N_OUT, mem=mem,
                                       hbm_budget=budget)
    lo = 1
    if rule(hi)["shards"] < 2:
        raise ValueError(f"no N up to {hi} needs 2 shards of {budget} bytes")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if rule(mid)["shards"] >= 2:
            hi = mid
        else:
            lo = mid
    return dict(N=hi, budget=int(budget), at_N=rule(hi), below=rule(hi - 1))


def rule_stage(rows=None, device=None) -> dict:
    """The fitted rule from ``rows`` (mem rows; runs the cdf half of the
    mem stage when None) and the 2-shard N, extrapolated, not run."""
    device = resolve_device(device)
    if rows is None:
        rows = mem_stage(selects=("cdf",), device=device)["rows"]
    two = two_shard_n(device)
    fit = fit_rule(rows)
    return {"stage": "rule", "card": card_line(device), "chains": N_OUT,
            "fit": fit, "two_shards": dict(
                two, note="extrapolated from estimate_product_memory, "
                          "not run"),
            "fitted_peak_reaches_budget_at_N": fit_budget_n(
                fit, two["budget"]),
            "memory": torch.cuda.get_device_properties(device).total_memory
            if device.type == "cuda" else None}


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stage", nargs="?", default="all",
                    choices=("mem", "time", "sharded", "rule", "all"))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    device = resolve_device(device)
    t0 = time.perf_counter()
    lines, mem = [], None
    stages = {"mem": lambda: mem_stage(device=device),
              "time": lambda: time_stage(device=device),
              "sharded": lambda: sharded_stage(device=device),
              "rule": lambda: rule_stage(mem, device=device)}
    for name in ("mem", "time", "sharded", "rule"):
        if args.stage in (name, "all"):
            res = stages[name]()
            if name == "mem":
                mem = res["rows"]
            lines.append(json.dumps(res))
            print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    print(f"scale_envelope {args.stage}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
