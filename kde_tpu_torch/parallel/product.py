"""Chain-sharded Gibbs products and multi-host start-up (ports
``kde_tpu/parallel/product.py:31-117``).

The Gibbs chains of a product are independent given their random streams
(SURVEY §2), so the product scales by splitting the chain axis over the
mesh's ``chains`` ranks; every rank holds the whole level plan.  Every rank
draws the streams of all ``n_out`` chains exactly as the unsharded keyed
call does, keeps its own rows and runs them; the points and labels are then
all-gathered, so each rank returns the whole product, equal to
``prod_appx_ms_gibbs(..., key=<the same int>, select="cdf")``.

Start every rank with :func:`initialize_multihost`, build the mesh with
``make_mesh``, and call the sharded entry points with the same arguments on
every rank (the same densities, built from the same data).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..density import KDE, kde
from ..ops import gibbs as _g
from ..utils.random import make_generator
from .collectives import gather_rows, psum, shared_seed
from .mesh import CHAINS, axis_size, chains_rows, pad_to_multiple


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: str = "nccl",
                         timeout: Optional[float] = None) -> None:
    """Join this process to the world (``dist.init_process_group``).

    ``coordinator_address`` is ``host:port`` (TCP rendezvous at
    ``tcp://host:port``) or a full init URL such as ``file:///path``.  With
    no arguments the torchrun variables ``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK`` and ``WORLD_SIZE`` give them (the counterpart of JAX's
    auto-detection).  ``backend`` is explicit: ``nccl`` for one GPU per
    rank (the rank's device becomes ``LOCAL_RANK``, or the rank modulo the
    visible GPUs), ``gloo`` for CPU processes.  ``timeout`` (seconds)
    bounds every collective, so a rank that never arrives fails the run
    instead of hanging it."""
    env = os.environ
    if coordinator_address is None:
        missing = [v for v in ("MASTER_ADDR", "MASTER_PORT")
                   if v not in env]
        if missing:
            raise ValueError(f"initialize_multihost: no coordinator_address "
                             f"and no {missing} in the environment")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id, **kw)


def prod_appx_ms_gibbs_sharded(mesh: DeviceMesh,
                               n_out: int,
                               densities: Sequence[KDE],
                               n_iter: int = 3,
                               add_entropy: bool = True,
                               partial_dim_mask=None,
                               key=None,
                               diagnostics: bool = False,
                               dtype=None):
    """:func:`kde_tpu_torch.prod_appx_ms_gibbs` with the chains split over
    ``mesh``'s ``chains`` axis (``n_out`` padded to a multiple of it; the
    pad chains run on streams of 0.5 and 0 and are dropped).  Draws with
    the flat inverse CDF.  ``key``: an int seed, or a ``torch.Generator`` /
    ``None`` from which rank 0 draws the seed every rank uses.

    Returns ``(points [d, n_out], indices [ndens, n_out])`` on this rank's
    device and, with ``diagnostics``, a dict with the ``mean`` and ``std``
    (ddof 0) of the points over the ``n_out`` chains, from all-reduced
    sums."""
    densities = list(densities)
    device = densities[0].device
    dtype = dtype or densities[0].dtype
    # density-attached manifold hooks flow exactly as in product()
    hooks = _g.normalize_hooks(*_g._density_hooks(densities),
                               densities[0].ndim)
    # device-resident densities (e.g. an earlier product) take the
    # device-built plan, as in the unsharded keyed call
    plan = _g._get_plan(densities, n_out, dtype, device,
                        _g._resolve_plan_impl(densities, "auto", False))
    dn, d = plan.ndens, plan.ndim
    mask = _g._mask_tensor(partial_dim_mask, dn, d, device)[None]
    bu, bn = _g._stream_sizes(dn, d, plan.n_levels, n_iter)
    gen = make_generator(shared_seed(key, device), device)
    u, nrm, _ = _g._keyed_streams(gen, n_out, bu, bn, dtype, device, "cdf")
    n_pad = pad_to_multiple(n_out, axis_size(mesh, CHAINS))
    u = torch.nn.functional.pad(u, (0, 0, 0, n_pad - n_out), value=0.5)
    nrm = torch.nn.functional.pad(nrm, (0, 0, 0, n_pad - n_out))
    rows = chains_rows(mesh, n_out)
    pts, idx, _ = _g._gibbs_all_chains(
        u[None, rows], nrm[None, rows], _g._stack_plans([plan]), mask,
        n_iter, add_entropy, "cdf", hooks=hooks)
    out = (gather_rows(pts[0], mesh, CHAINS, n_out).T,
           gather_rows(idx[0], mesh, CHAINS, n_out).T)
    if diagnostics:
        real = (torch.arange(rows.start, rows.stop, device=device)
                < n_out)[:, None]
        loc = pts[0]
        mean = psum(torch.where(real, loc, 0.0).sum(dim=0), mesh,
                    CHAINS) / n_out
        var = psum(torch.where(real, (loc - mean) ** 2, 0.0).sum(dim=0),
                   mesh, CHAINS) / n_out
        out = out + ({"mean": mean, "std": torch.sqrt(var)},)
    return out


def product_sharded(mesh: DeviceMesh, densities: Sequence[KDE],
                    n_iter: int = 5, key=None) -> KDE:
    """Sharded ``*``: the chain-sharded Gibbs product sized at the mean
    component count, then the LOOCV refit of the gathered samples on this
    rank's device (one launch of the LOOCV search kernel K4).  The result stays on
    the device and carries the densities' manifold hooks, as ``product()``
    does (the JAX package's ``product_sharded`` drops them,
    ``kde_tpu/parallel/product.py:106``)."""
    densities = list(densities)
    addop, diffop, get_mu, get_lambda = _g._density_hooks(densities)
    n_out = int(round(float(np.mean([p.npts for p in densities]))))
    pts, _ = prod_appx_ms_gibbs_sharded(mesh, n_out, densities,
                                        n_iter=n_iter, key=key)
    return kde(pts, addop=addop, diffop=diffop, get_mu=get_mu,
               get_lambda=get_lambda)
