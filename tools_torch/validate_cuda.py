"""Statistical acceptance of the port's float32 Gibbs products on the card:
the counterpart of ``tools/validate_tpu.py`` on ``kde_tpu_torch``.

Every row runs keyed float32 products and holds each trial to the
reference's coarse moment brackets (test/runtests.jl:167-182: the sample
mean within one product std-dev of the true centre, every per-dim std-dev
within [0.66, 1.33] of it; on the circle the residuals are taken
on-manifold), then votes over its trials.  The rows are the JAX tool's,
with rows added so that every layout of the chain kernel K3
(``ops/gibbs_chain.py::launch_plan``) is held to the brackets:

  A  the reference grid: 8 configs x plan host/device      10 trials, >= 5
  B  2 x N in 2-D, 1,000 chains, N = 50k .. 400k (block)    5 trials, >= 3
  C  the staged layout: 4,100 chains over 2 x 100k; the
     slice's 20,000 chains over 2 x 20k; 4,100 chains over
     2 x 20k circular (d = 1) and SE(2) (d = 3)              5 trials, >= 3
  D  circular M = 2, 4 straddling +-pi; SE(2) M = 3         10 trials, >= 5
  E  BatchedProductSampler: Euclidean and circular B = 4
     (every set in bracket); the bench headline
     B = 6 x [2 x 1,000], 1,000 chains                      10 trials, >= 5
  F  the kernel-sharded engine over two gloo ranks that
     share the card, in child processes; on the card every
     selection on K6 (ops/sharded_select.py), none on its
     twins                                                  10 trials, >= 5
  G  negative control: D's circular M = 2 with the hooks
     stripped from densities and product                    10 trials, <= 2
  H  keyed gumbel (labels from the counter noise) on each
     layout: A's D 2 M 2 (warp), B's 2 x 100k (block), C's
     4,100 x 2 x 100k (staged), D's circular M = 2 and SE(2)
     M = 3, E's headline; and G's control with gumbel       as its row's

The circular densities sit tightly either side of the +-pi seam with no
sample mass across it, so an engine that ignores the hooks puts the
product near the Euclidean midpoint 0, a wrapped residual of ~pi outside
every bracket: G must fail, or the brackets have no teeth.  Trial seeds
derive from the JAX tool's 17, 23, 29, 31, 37, 41 and 43 through
``utils.random.split``; keyed draws differ between the two packages
(PARITY.md), so the rows match the JAX tool's in configuration, not in
draws.  Each row records its selection, ``launch_plan``'s layout for its
chain count and widest level, its wins, threshold, seconds and K3
launches.

    python3 -m tools_torch.validate_cuda [--out VALIDATE_CUDA.json]

writes the record (the card's name and power limit, torch and CUDA
versions, the rows, ``pass``) and exits nonzero if any row fails.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

import kde_tpu_torch as kt
from kde_tpu_torch import manifolds as m
from kde_tpu_torch.ops import gibbs_chain, sharded_select
from kde_tpu_torch.ops.balltree import n_levels
from kde_tpu_torch.ops.device_plan import level_widths
from kde_tpu_torch.utils.random import split

from . import card_line, free_port, resolve_device, sync

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "VALIDATE_CUDA.json")
F32 = torch.float32
BW = 0.1                 # circular kernels' bandwidth
NOISE = 0.05             # 6 sigma below the 0.3 seam margin: no sample
OFF = 0.3                # crosses +-pi
WORKER_TIMEOUT = 900     # seconds: row F's ranks, their collectives

CIRC = dict(addop=(m.circular_add,), diffop=(m.circular_diff,),
            get_mu=(m.circular_mu,), get_lambda=(m.circular_lambda,))
SE2 = dict(addop=(m.euclid_add, m.euclid_add, m.circular_add),
           diffop=(m.euclid_diff, m.euclid_diff, m.circular_diff),
           get_mu=(m.euclid_mu, m.euclid_mu, m.circular_mu),
           get_lambda=(m.euclid_lambda, m.euclid_lambda, m.circular_lambda))


# ---------------------------------------------------------------------------
# the brackets (tools/validate_tpu.py:35-42, 98-100, 135-146, 192-198)
# ---------------------------------------------------------------------------

def moment_ok(pts, D, M, dev=1.0):
    """The reference's brackets (test/runtests.jl:167-182)."""
    prod_dev = np.sqrt(dev ** (2 * M) / (M * dev ** 2))
    t1 = np.linalg.norm(pts.mean(axis=1)) < 1.0 * prod_dev
    t2 = all(0.66 * prod_dev < pts[i].std() < 1.33 * prod_dev
             for i in range(D))
    return bool(t1 and t2)


def _wrap(a):
    return a - 2.0 * np.pi * np.round(a / (2.0 * np.pi))


def circ_ok(th, M, noise=NOISE):
    """Circular analog of moment_ok around the true center pi: residual
    mean within prod_dev, residual std in the reference's 0.66-1.33
    band.  dev = per-density std (sample noise + kernel bw)."""
    dev = float(np.hypot(noise, BW))
    prod_dev = dev / np.sqrt(M)
    d = _wrap(np.asarray(th) - np.pi)
    return bool(abs(d.mean()) < 1.0 * prod_dev
                and 0.66 * prod_dev < d.std() < 1.33 * prod_dev)


def se2_ok(pts, M, noise=NOISE):
    """SE(2): the reference's brackets on (x, y) with dev ~ sqrt(1 +
    bw^2), :func:`circ_ok` on theta."""
    dev = float(np.hypot(1.0, BW))
    prod_dev = np.sqrt(dev ** (2 * M) / (M * dev ** 2))
    e1 = np.linalg.norm(pts[:2].mean(axis=1)) < 1.0 * prod_dev
    e2 = all(0.66 * prod_dev < pts[i].std() < 1.33 * prod_dev
             for i in range(2))
    return bool(e1 and e2) and circ_ok(pts[2], M, noise)


# ---------------------------------------------------------------------------
# trials: each takes (rng, key, device) and returns whether it is in bracket
# ---------------------------------------------------------------------------

def _host(x):
    return x.double().cpu().numpy()


def grid_trial(rng, key, device, D=3, M=6, N=100, n=100, dev=1.0, mcmc=5,
               plan="host", select="cdf"):
    """The reference grid's testProds (test/runtests.jl:189-201): LOOCV
    fits of M standard-normal D-dim point sets."""
    dens = [kt.kde(dev * rng.normal(size=(D, N)), dtype=F32, device=device)
            for _ in range(M)]
    pts, _ = kt.prod_appx_ms_gibbs(n, dens, n_iter=mcmc, key=key, plan=plan,
                                   select=select)
    return moment_ok(_host(pts), D, M, dev)


def large_trial(rng, key, device, N, n, D=2, M=2, mcmc=5, select="cdf"):
    """M standard-normal N-component densities at the rule-of-thumb
    bandwidth 1.06 N^-0.2."""
    dens = [kt.kde(rng.normal(size=(D, N)).astype(np.float32),
                   [float(1.06 * N ** -0.2)], dtype=F32, device=device)
            for _ in range(M)]
    pts, _ = kt.prod_appx_ms_gibbs(n, dens, n_iter=mcmc, key=key,
                                   select=select)
    return moment_ok(_host(pts), D, M)


def _circ_dens(rng, N, offset, device, hooks):
    th = _wrap(np.pi + offset + NOISE * rng.normal(size=(1, N)))
    return kt.kde(th, [BW], dtype=F32, device=device, **hooks)


def circ_trial(rng, key, device, M, N=100, n=100, mcmc=5, hooks=CIRC,
               select="cdf"):
    """M circular densities at pi + linspace(-OFF, OFF, M); ``hooks={}``
    strips the hooks (the negative control)."""
    dens = [_circ_dens(rng, N, o, device, hooks)
            for o in np.linspace(-OFF, OFF, M)]
    pts, _ = kt.prod_appx_ms_gibbs(n, dens, n_iter=mcmc, key=key,
                                   select=select, **hooks)
    return circ_ok(_host(pts)[0], M)


def se2_trial(rng, key, device, M=3, N=100, n=100, mcmc=5, select="cdf"):
    """SE(2)-style mixed dims: (x, y) standard normal, theta circular
    around pi."""
    dens = []
    for o in np.linspace(-OFF, OFF, M):
        xy = rng.normal(size=(2, N))
        th = _wrap(np.pi + o + NOISE * rng.normal(size=(1, N)))
        dens.append(kt.kde(np.vstack([xy, th]), [BW], dtype=F32,
                           device=device, **SE2))
    pts, _ = kt.prod_appx_ms_gibbs(n, dens, n_iter=mcmc, key=key,
                                   select=select, **SE2)
    return se2_ok(_host(pts), M)


def batched_trial(rng, key, device, B=4, D=2, M=2, N=100, n=100, mcmc=5):
    """B sets of M LOOCV-fitted standard-normal densities through
    BatchedProductSampler; every set must be in bracket."""
    sets = [[kt.kde(rng.normal(size=(D, N)), dtype=F32, device=device)
             for _ in range(M)] for _ in range(B)]
    pts, _ = kt.BatchedProductSampler(sets, n_out=n, n_iter=mcmc).sample(key)
    pts = _host(pts)
    return all(moment_ok(pts[b], D, M) for b in range(B))


def batched_circ_trial(rng, key, device, B=4, M=2, N=100, n=100, mcmc=5):
    """B circular sets through BatchedProductSampler (the hooked serving
    path); every set must be in bracket."""
    offs = np.linspace(-OFF, OFF, M)
    sets = [[_circ_dens(rng, N, o, device, CIRC) for o in offs]
            for _ in range(B)]
    pts, _ = kt.BatchedProductSampler(sets, n_out=n, n_iter=mcmc).sample(key)
    pts = _host(pts)
    return all(circ_ok(pts[b, 0], M) for b in range(B))


def headline_trial(rng, key, device, B=6, N=1000, n=1000, mcmc=5,
                   select="cdf"):
    """The bench headline (bench.py:37-40, 177-188): one 2-D pair at bw
    0.1, N(0, I) and N(0.5, I), B times per call; every set's residual
    about the product's centre 0.25 must be in bracket."""
    dens = [kt.kde(rng.normal(size=(2, N)) + s, [0.1], dtype=F32,
                   device=device) for s in (0.0, 0.5)]
    pts, _ = kt.BatchedProductSampler([dens] * B, n_out=n,
                                      n_iter=mcmc).sample(key, select=select)
    pts = _host(pts) - 0.25
    return all(moment_ok(pts[b], 2, 2) for b in range(B))


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------

class Row(NamedTuple):
    """One row: ``trial(rng, key, device)`` run ``trials`` times from the
    trial seeds of ``seed``; it passes with at least ``need`` wins (at most,
    for a ``control``).  ``chains``, ``npts`` and ``d`` give its shape, from
    which :func:`layout` reads K3's layout; ``select`` its label
    selection."""
    name: str
    group: str
    config: dict
    seed: int
    trials: int
    need: int
    trial: Optional[Callable]
    chains: int
    npts: tuple
    d: int
    control: bool = False
    select: str = "cdf"


def _kw(trial, **kw):
    return lambda rng, key, device, **more: trial(rng, key, device, **kw,
                                                   **more)


def _rows():
    rows = []
    for cfg in [dict(D=2, M=2), dict(D=2, M=4), dict(D=2, M=6),
                dict(D=3, M=6, mcmc=10), dict(D=4, M=6, n=200, mcmc=10),
                dict(D=3, M=5, N=300), dict(D=2, M=7, n=300),
                dict(D=3, M=2, mcmc=100)]:
        full = dict(dict(N=100, n=100, mcmc=5), **cfg)
        for plan in ("host", "device"):
            name = ("grid " + " ".join(f"{k}{v}" for k, v in cfg.items())
                    + f" {plan}")
            rows.append(Row(name, "A", dict(full, plan=plan), 17, 10, 5,
                            _kw(grid_trial, plan=plan, **cfg), full["n"],
                            (full["N"],) * full["M"], full["D"]))
    for N in (50_000, 100_000, 200_000, 400_000):
        rows.append(Row(f"large 2x{N}", "B",
                        dict(D=2, M=2, N=N, n=1000, mcmc=5), 23, 5, 3,
                        _kw(large_trial, N=N, n=1000), 1000, (N, N), 2))
    for N, n in ((100_000, 4100), (20_000, 20_000)):
        rows.append(Row(f"staged {n} x 2x{N}", "C",
                        dict(D=2, M=2, N=N, n=n, mcmc=5), 23, 5, 3,
                        _kw(large_trial, N=N, n=n), n, (N, N), 2))
    rows.append(Row("staged circular 4100 x 2x20000", "C",
                    dict(D=1, M=2, N=20_000, n=4100, mcmc=5), 23, 5, 3,
                    _kw(circ_trial, M=2, N=20_000, n=4100), 4100,
                    (20_000,) * 2, 1))
    rows.append(Row("staged se2 4100 x 2x20000", "C",
                    dict(D=3, M=2, N=20_000, n=4100, mcmc=5), 23, 5, 3,
                    _kw(se2_trial, M=2, N=20_000, n=4100), 4100,
                    (20_000,) * 2, 3))
    for M in (2, 4):
        rows.append(Row(f"circular M={M}", "D",
                        dict(D=1, M=M, N=100, n=100, mcmc=5), 31, 10, 5,
                        _kw(circ_trial, M=M), 100, (100,) * M, 1))
    rows.append(Row("se2 M=3", "D", dict(D=3, M=3, N=100, n=100, mcmc=5),
                    37, 10, 5, se2_trial, 100, (100,) * 3, 3))
    rows.append(Row("batched B=4", "E",
                    dict(D=2, M=2, N=100, n=100, mcmc=5, B=4), 41, 10, 5,
                    batched_trial, 100, (100, 100), 2))
    rows.append(Row("batched circular B=4", "E",
                    dict(D=1, M=2, N=100, n=100, mcmc=5, B=4), 43, 10, 5,
                    batched_circ_trial, 100, (100, 100), 1))
    rows.append(Row("headline 6x[2x1000]", "E",
                    dict(D=2, M=2, N=1000, n=1000, mcmc=5, B=6), 41, 10, 5,
                    headline_trial, 1000, (1000, 1000), 2))
    for cfg in SHARDED:
        rows.append(Row("kernel-sharded " + " ".join(
            f"{k}{v}" for k, v in cfg.items()), "F", dict(cfg), 29, 10, 5,
            None, cfg["n"], (cfg["N"],) * cfg["M"], cfg["D"]))
    rows.append(Row("control circular M=2 no hooks", "G",
                    dict(D=1, M=2, N=100, n=100, mcmc=5), 31, 10, 2,
                    _kw(circ_trial, M=2, hooks={}), 100, (100, 100), 1,
                    control=True))
    # H: each row above that stands for a layout, again with gumbel
    for name in ("grid D2 M2 host", "large 2x100000",
                 "staged 4100 x 2x100000", "circular M=2", "se2 M=3",
                 "headline 6x[2x1000]", "control circular M=2 no hooks"):
        row = next(r for r in rows if r.name == name)
        trial = row.trial
        rows.append(row._replace(
            name="gumbel " + name, group="H", select="gumbel",
            trial=lambda rng, key, device, t=trial: t(rng, key, device,
                                                      select="gumbel")))
    return rows


SHARDED = (dict(D=2, M=2, N=128, n=100, mcmc=5),
           dict(D=3, M=4, N=256, n=100, mcmc=5))
ROWS = _rows()
BY_NAME = {r.name: r for r in ROWS}
# chip_smoke.py phase 13: A's two grid configs, one row of each layout and
# D's circular row with its control, each of those again with gumbel but
# the headline (E's is the warp layout's batched row)
QUICK = ("grid D2 M2 host", "grid D2 M2 device", "grid D3 M6 mcmc10 host",
         "grid D3 M6 mcmc10 device", "large 2x100000",
         "staged 4100 x 2x100000", "headline 6x[2x1000]", "circular M=2",
         "control circular M=2 no hooks", "gumbel grid D2 M2 host",
         "gumbel large 2x100000", "gumbel staged 4100 x 2x100000",
         "gumbel circular M=2", "gumbel control circular M=2 no hooks")


def widest_level(chains: int, npts: Sequence[int]) -> int:
    """Candidates of the widest level of the plan of densities of
    ``npts`` points at ``chains`` chains (host and device plans pack the
    same levels)."""
    L = n_levels(chains, list(npts))
    return max(max(level_widths(n, L)) for n in npts)


def layout(row: Row) -> str:
    """K3's layout for the row's sets: ``launch_plan`` of its chains and
    widest level, float32, its dims."""
    return gibbs_chain.launch_plan(row.chains, widest_level(row.chains,
                                                            row.npts),
                                   F32, row.d)


def trial_seeds(row: Row):
    """``(data_seed, key)`` of each trial: ``split`` of the row's seed into
    trials, each split into the data's seed and the product's key."""
    return [split(s, 2) for s in split(row.seed, row.trials)]


def run_row(row: Row, device) -> dict:
    """Run the row's trials on ``device`` and return its record; row F
    runs in two child processes (:func:`run_sharded`)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    k6 = {"k6_launches": 0, "k6_twin_stages": 0}
    if row.group == "F":
        ranks = run_sharded(row, device)
        wins, k3 = ranks[0]["wins"], sum(r["k3_launches"] for r in ranks)
        k6 = {k: sum(r[k] for r in ranks) for k in k6}
    else:
        k0, wins = gibbs_chain.LAUNCHES, 0
        for data_seed, key in trial_seeds(row):
            wins += bool(row.trial(np.random.default_rng(data_seed), key,
                                   device))
        sync(device)
        k3 = gibbs_chain.LAUNCHES - k0
    ok = wins <= row.need if row.control else wins >= row.need
    if row.group == "F" and device.type == "cuda":
        # the engine's selections belong on K6 on the card
        ok = ok and k6["k6_launches"] > 0 and k6["k6_twin_stages"] == 0
    rec = dict(name=row.name, row=row.group, **row.config,
               select=row.select, layout=layout(row), chains=row.chains,
               widest_level=widest_level(row.chains, row.npts), wins=wins,
               of=row.trials,
               need=(f"<= {row.need}" if row.control else f">= {row.need}"),
               passed=bool(ok), seconds=time.perf_counter() - t0,
               k3_launches=k3, **k6)
    return rec


def run(device=None, names: Optional[Sequence[str]] = None,
        log=print) -> dict:
    """Every row (or the rows ``names``) on ``device`` (the card unless
    given); returns the record :func:`main` writes."""
    device = resolve_device(device)
    rows = ROWS if names is None else [BY_NAME[n] for n in names]
    t0 = time.perf_counter()
    recs = []
    for row in rows:
        rec = run_row(row, device)
        recs.append(rec)
        log(f"{row.group} {row.name}: {rec['wins']}/{rec['of']} (need "
            f"{rec['need']}), layout {rec['layout']}, "
            f"{rec['seconds']:.2f} s, K3 {rec['k3_launches']}, K6 "
            f"{rec['k6_launches']} (twin stages {rec['k6_twin_stages']})",
            flush=True)
    return {"date": datetime.date.today().isoformat(),
            "card": card_line(device), "device": str(device),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "dtype": "float32",
            "thresholds": {"A, D, E, F": ">= 5 of 10", "B, C": ">= 3 of 5",
                           "G (control)": "<= 2 of 10",
                           "H": "as the row it repeats"},
            "rows": recs, "seconds": time.perf_counter() - t0,
            "pass": all(r["passed"] for r in recs)}


# ---------------------------------------------------------------------------
# row F: two ranks share the card over gloo
# ---------------------------------------------------------------------------

def sharded_wins(row: Row, device) -> int:
    """Wins of a row F over the world's ranks (every rank calls this with
    the same arguments, inside the world): M LOOCV-fitted standard-normal
    densities split over a ``kernels`` mesh of all ranks, keyed products
    held to :func:`moment_ok`."""
    from kde_tpu_torch import parallel as par
    mesh = par.make_mesh(axis_name=par.KERNELS)
    D, M, N, n, mcmc = (row.config[k] for k in ("D", "M", "N", "n", "mcmc"))
    wins = 0
    for data_seed, key in trial_seeds(row):
        rng = np.random.default_rng(data_seed)
        dens = [kt.kde(rng.normal(size=(D, N)), dtype=F32, device=device)
                for _ in range(M)]
        pts, _ = par.prod_appx_ms_gibbs_kernel_sharded(mesh, n, dens,
                                                       n_iter=mcmc, key=key)
        wins += moment_ok(_host(pts), D, M)
    return wins


def run_sharded(row: Row, device, world: int = 2) -> list:
    """Row F: ``world`` child processes of this module join a gloo world
    on ``device`` and run :func:`sharded_wins`; a rank that fails or
    outlives WORKER_TIMEOUT raises."""
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tools_torch.validate_cuda",
         "--sharded-worker", str(r), str(world), port, str(device),
         row.name], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + WORKER_TIMEOUT
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
            raise RuntimeError(f"kernel-sharded rank {r} exited "
                               f"{proc.returncode}:\n{text[-4000:]}")
    ranks = [json.loads(text.strip().splitlines()[-1]) for text in outs]
    if len({r["wins"] for r in ranks}) != 1:
        raise RuntimeError(f"kernel-sharded ranks disagree: {ranks}")
    return ranks


def sharded_worker(rank: int, world: int, port: str, device: str,
                   name: str) -> None:
    """One rank of row F: gloo over ``device`` (every rank on the same
    card); prints one JSON line last."""
    from kde_tpu_torch import parallel as par
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    else:
        kt.config.DEVICE = "cpu"
    par.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                             backend="gloo", timeout=WORKER_TIMEOUT)
    try:
        k0, s0 = gibbs_chain.LAUNCHES, sharded_select.LAUNCHES
        t0 = sharded_select.TWIN_STAGES
        wins = sharded_wins(BY_NAME[name], device)
        k3 = gibbs_chain.LAUNCHES - k0
        k6 = sharded_select.LAUNCHES - s0
        twin = sharded_select.TWIN_STAGES - t0
    finally:
        torch.distributed.destroy_process_group()
    print(json.dumps({"rank": rank, "wins": wins, "k3_launches": k3,
                      "k6_launches": k6, "k6_twin_stages": twin}),
          flush=True)


def main(argv=None, device=None, names=None) -> int:
    """The command line: run the rows, write the record to ``--out``
    (VALIDATE_CUDA.json at the repo root by default), print the wall time;
    returns 1 if any row failed."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    res = run(device, names)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"{res['card']}: {sum(r['passed'] for r in res['rows'])}/"
          f"{len(res['rows'])} rows passed in {res['seconds']:.1f} s -> "
          f"{args.out}", flush=True)
    print("PASS" if res["pass"] else "FAIL", flush=True)
    return 0 if res["pass"] else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-worker"]:
        sharded_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                       sys.argv[5], sys.argv[6])
    else:
        sys.exit(main())
