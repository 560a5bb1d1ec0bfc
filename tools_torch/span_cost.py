"""What the port's spans (``kde_tpu_torch/utils/spans.py``) cost, on the
card: host-clock times of two loops with spans recorded and without.

  star   ``product([p, q], key=k_i)`` of two fresh device-resident SE(2)
         beliefs of 20,000 points (x, y and a circular theta), each request
         ending in ``torch.cuda.synchronize()``: the benchmark's
         ``star_pose2_2x20k`` request;
  serve  ``BatchedProductSampler.sample(key_i)`` over 6 sets of two 2-D
         beliefs of 1,000 points, 1,000 draws a set, two calls in flight:
         the ``serve_point2_b6x1k`` call; ms a call over blocks of 50 calls
         ending in a synchronise, and each ``sample()``'s host ms.

    python3 -m tools_torch.span_cost [--spans on-off|off] [--star N]
                                     [--serve N] [--seed S] [--tree DIR]
                                     [--out FILE]

``--spans on-off`` runs the loops with ``spans.recording()`` on and off in
turns (request by request for star, block by block for serve), N of each,
and counts the records a request leaves; ``off`` runs them with no
recording, N in all, and needs no span code, so ``--tree DIR`` can time a
checkout of the port from before the spans (its ``kde_tpu_torch`` is
imported from DIR).  Prints one JSON line with the medians and the card's
name and power limit; ``--out`` also writes it to FILE.  Runs on the card
unless a caller passes ``device="cpu"``; without a card it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time

import torch

from . import card_line, resolve_device, sync

STAR_N, STAR_D, STAR_PAIRS = 20_000, 3, 8
SERVE_SETS, SERVE_N, SERVE_OUT, SERVE_DEPTH = 6, 1_000, 1_000, 2
BLOCK = 50


def _points(g, n, d, device, circular):
    """``[d, n]`` float32 points of a 3-mode mixture; the last dim wrapped
    to (-pi, pi] when ``circular``."""
    f64 = dict(dtype=torch.float64, device=device)
    centres = 6.0 * torch.rand((3, d), generator=g, **f64) - 3.0
    mode = torch.randint(0, 3, (n,), generator=g, device=device)
    x = centres[mode] + 0.5 * torch.randn((n, d), generator=g, **f64)
    if circular:
        x[:, -1] = torch.pi - torch.remainder(torch.pi - x[:, -1],
                                              2 * torch.pi)
    return x.T.contiguous().float()


def _bw(pts):
    """Silverman's rule per dim, ``[d]``."""
    d, n = pts.shape
    return pts.std(dim=1) * (4.0 / ((d + 2) * n)) ** (1.0 / (d + 4))


def _hooks(kt, d):
    m = kt.manifolds
    quads = [(m.euclid_add, m.euclid_diff, m.euclid_mu, m.euclid_lambda)
             ] * (d - 1) + [(m.circular_add, m.circular_diff,
                             m.circular_mu, m.circular_lambda)]
    return {name: tuple(q[i] for q in quads) for i, name in
            enumerate(("addop", "diffop", "get_mu", "get_lambda"))}


def _median(xs):
    return statistics.median(xs) if xs else None


def star_loop(kt, spans, arms, n, seed, device, n_pts=STAR_N):
    """ms of each star request by arm (``on`` / ``off``), the arms in turns,
    ``n`` requests each, after two warm-up requests."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    pts = [[_points(g, n_pts, STAR_D, device, True) for _ in range(2)]
           for _ in range(STAR_PAIRS)]
    hooks = _hooks(kt, STAR_D)

    def request(i):
        dens = [kt.kde(x, _bw(x), **hooks) for x in pts[i % STAR_PAIRS]]
        out = kt.product(dens, key=seed + i)
        sync(device)
        return out
    for i in range(2):
        request(i)
    ms, records = {a: [] for a in arms}, []
    for i in range(n * len(arms)):
        arm = arms[i % len(arms)]
        with spans.recording() if arm == "on" else contextlib.nullcontext():
            t = time.perf_counter()
            request(i)
            ms[arm].append(1e3 * (time.perf_counter() - t))
        if arm == "on":
            records.append(len(spans.records()))
    return ms, records


def serve_loop(kt, spans, arms, n, seed, device, n_pts=SERVE_N,
               n_out=SERVE_OUT, block=BLOCK):
    """ms a call over blocks of ``block`` calls, and each call's host ms
    inside ``sample()``, by arm, the arms in turns block by block, ``n``
    calls each."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    sets = [[kt.kde(x, _bw(x)) for x in
             (_points(g, n_pts, 2, device, False) for _ in range(2))]
            for _ in range(SERVE_SETS)]
    sampler = kt.BatchedProductSampler(sets, n_out=n_out, n_iter=5)
    for i in range(4):
        sampler.sample(seed + i)
    sync(device)
    call_ms = {a: [] for a in arms}
    host_ms = {a: [] for a in arms}
    blocks = -(-n // block)
    for b in range(blocks * len(arms)):
        arm = arms[b % len(arms)]
        inflight = []
        with spans.recording() if arm == "on" else contextlib.nullcontext():
            t0 = time.perf_counter()
            for i in range(block):
                h = time.perf_counter()
                sampler.sample(seed + b * block + i)
                host_ms[arm].append(1e3 * (time.perf_counter() - h))
                if device.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record()
                    inflight.append(ev)
                    if len(inflight) >= SERVE_DEPTH:
                        inflight.pop(0).synchronize()
            sync(device)
            call_ms[arm].append(1e3 * (time.perf_counter() - t0) / block)
        if arm == "on":
            spans.records()
    return call_ms, host_ms


def run(mode="on-off", star=40, serve=500, seed=1, device=None, sizes=None):
    """Both loops; ``sizes`` overrides the loops' sizes (the tests')."""
    import kde_tpu_torch as kt
    device = resolve_device(device)
    if mode == "on-off":
        from kde_tpu_torch.utils import spans
        arms = ("on", "off")
    else:
        spans, arms = None, ("off",)
    sizes = sizes or {}
    out = {"card": card_line(device), "mode": mode, "torch": torch.__version__,
           "port": kt.__file__}
    ms, records = star_loop(kt, spans, arms, star, seed, device,
                            **sizes.get("star", {}))
    out["star_ms"] = {a: _median(v) for a, v in ms.items()}
    out["star_ms_all"] = ms
    out["star_records_per_request"] = _median(records)
    call, host = serve_loop(kt, spans, arms, serve, seed, device,
                            **sizes.get("serve", {}))
    out["serve_call_ms"] = {a: _median(v) for a, v in call.items()}
    out["serve_host_ms"] = {a: _median(v) for a, v in host.items()}
    out["serve_blocks"] = {a: len(v) for a, v in call.items()}
    return out


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spans", choices=("on-off", "off"), default="on-off")
    ap.add_argument("--star", type=int, default=40)
    ap.add_argument("--serve", type=int, default=500)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--tree")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.tree:
        sys.path.insert(0, args.tree)
    res = run(args.spans, args.star, args.serve, args.seed, device)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
