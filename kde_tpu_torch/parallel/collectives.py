"""Collectives over a named mesh axis: the eager counterparts of
``lax.pmax``, ``lax.pmin``, ``lax.psum`` and ``lax.all_gather`` inside the
JAX package's ``shard_map`` programs (``lax.axis_index`` is
``mesh.axis_index``).

Each is a ``torch.distributed`` call on the axis's process group
(``mesh.get_group(axis)``), issued at every axis size, 1 included, so a
single-rank NCCL run goes through NCCL too.  An axis the mesh does not have
is a reduction over one rank and issues nothing.  :func:`psum` also takes a
tuple of axes, ``lax.psum(x, (CHAINS, KERNELS))``: one all-reduce on the
group of all the listed axes' ranks (the world, which a mesh spans, where
it lists every axis of the mesh).  Every rank must call the
same collectives in the same order: a loop around them may branch only on
values that are replicated, i.e. on results of these calls, which are
bitwise equal on every rank of the group.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.random import split


def _group(mesh: DeviceMesh, axis):
    """The process group of ``axis`` (or a tuple of axes) on ``mesh``,
    found once a mesh and kept on it."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    groups = mesh.__dict__.setdefault("_kde_groups", {})
    if axes not in groups:
        groups[axes] = _group_of(mesh, axes)
    return groups[axes]


def _group_of(mesh: DeviceMesh, axes: tuple):
    names = mesh.mesh_dim_names or ()
    present = [a for a in names if a in axes]
    if not present:
        return None
    if len(present) == 1:
        return mesh.get_group(present[0])
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size()} ranks in a world of "
                         f"{dist.get_world_size()}: a mesh spans the world")
    return dist.group.WORLD


def _all_reduce(x: torch.Tensor, op, mesh: DeviceMesh, axis,
                inplace: bool = False):
    group = _group(mesh, axis)
    if group is None:
        return x
    if inplace and not x.is_contiguous():
        raise ValueError("an all-reduce in place needs a contiguous tensor")
    y = x if inplace else x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def pmax(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Elementwise max over the ranks of ``axis``."""
    return _all_reduce(x, dist.ReduceOp.MAX, mesh, axis)


def pmin(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Elementwise min over the ranks of ``axis``."""
    return _all_reduce(x, dist.ReduceOp.MIN, mesh, axis)


def psum(x: torch.Tensor, mesh: DeviceMesh, axis,
         inplace: bool = False) -> torch.Tensor:
    """Elementwise sum over the ranks of ``axis``, or of a tuple of axes
    (one all-reduce over all their ranks); with ``inplace`` into ``x``
    (contiguous) itself, which it returns."""
    return _all_reduce(x, dist.ReduceOp.SUM, mesh, axis, inplace)


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``[S, *x.shape]``: every rank's ``x`` in axis order (the list form of
    ``dist.all_gather``, which every torch version and backend takes)."""
    group = _group(mesh, axis)
    if group is None:
        return x[None]
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def gather_rows(x: torch.Tensor, mesh: DeviceMesh, axis: str,
                n: int) -> torch.Tensor:
    """The first ``n`` rows of every rank's ``x`` rows concatenated in axis
    order: a row-sharded tensor made whole (and its padding dropped)."""
    g = all_gather(x, mesh, axis)
    return g.reshape((-1,) + tuple(x.shape[1:]))[:n]


def shared_seed(key, device) -> int:
    """An int seed that is the same on every rank: an int key is one
    already; a ``torch.Generator`` (or ``None``, the module generator of
    ``device``) gives one draw on rank 0, broadcast to the world."""
    if isinstance(key, (int, np.integer)):
        return int(key)
    seed = torch.zeros(1, dtype=torch.int64, device=device)
    if dist.get_rank() == 0:
        seed[0] = split(key, 1, device)[0]
    dist.broadcast(seed, src=0)
    return int(seed.item())
