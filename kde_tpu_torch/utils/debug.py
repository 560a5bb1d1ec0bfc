"""Debug dumpers and profiling helpers (ports ``kde_tpu/utils/debug.py``).

The reference's introspection tools are ``printBallTree``
(src/BallTree01.jl:465-475) and the commented-out ``printGlbs`` chain-state
dumper (src/MSGibbs01.jl:64-79); ``profile_trace`` wraps ``torch.profiler``
and exports the port's spans (utils/spans.py), and ``fence`` is a
completion fence for timing.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

from ..ops.balltree import FlatBallTree
from . import spans


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def print_ball_tree(tree: FlatBallTree, digits: int = 6) -> None:
    """Field dump of the flat tree (reference printBallTree,
    src/BallTree01.jl:465-475 + src/BallTreeDensity01.jl:337-345)."""
    r = lambda a: np.round(a, digits)
    print(f"dims={tree.dims} num_points={tree.num_points} "
          f"multibandwidth={tree.multibandwidth}")
    print("centers =", r(tree.centers.reshape(-1)).tolist())
    print("ranges  =", r(tree.ranges.reshape(-1)).tolist())
    print("weights =", r(tree.weights).tolist())
    print("left    =", tree.left.tolist())
    print("right   =", tree.right.tolist())
    print("lowest  =", tree.lowest_leaf.tolist())
    print("highest =", tree.highest_leaf.tolist())
    print("perm    =", tree.permutation.tolist())
    print("means   =", r(tree.means.reshape(-1)).tolist())
    print("bw      =", r(tree.bandwidth.reshape(-1)).tolist())


def print_chain_state(points, indices, labels=None, sample: int = 0) -> None:
    """Per-chain dump of a Gibbs product result (the ``printGlbs``
    equivalent): the sampled point, its final labels and, when recorded,
    the per-level label path."""
    pts = _np(points)
    idx = _np(indices)
    print(f"chain {sample}: x={np.round(pts[:, sample], 4).tolist()} "
          f"labels={idx[:, sample].tolist()}")
    if labels is not None:
        lab = _np(labels)
        for j in range(lab.shape[1]):
            print(f"  density {j}: level path {lab[sample, j].tolist()}")


@contextlib.contextmanager
def profile_trace(logdir: str = "kde_tpu_torch_trace"):
    """Profile a region with ``torch.profiler`` (CPU, and CUDA when a card
    is present) and write a Chrome trace to ``logdir/trace.json``; yields
    the profiler, whose ``key_averages()`` sum the time by op.  The port's
    spans of the region (utils/spans.py: records that started in it; the
    trace holds them as ``kde_tpu_torch.<name>`` annotations) go to
    ``logdir/spans.json`` as ``{"records": [...], "dropped": n}``; the
    buffer is emptied, records left in it from before the region with
    it."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    t0 = spans._now()
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    lost = spans.dropped()
    recs = [r for r in spans.records() if r["start_ns"] >= t0]
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"records": recs, "dropped": lost}, f, default=str)


def fence(*outputs) -> float:
    """Wait for the work behind ``outputs`` and return a checksum: a
    ``torch.cuda.synchronize()`` when any tensor lies on a CUDA device,
    then the float sum of every tensor in nested lists, tuples and dicts."""
    leaves = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(outputs)
    if any(t.is_cuda for t in leaves):
        torch.cuda.synchronize()
    return float(sum(float(t.detach().double().sum()) for t in leaves))
