"""Device meshes over a ``torch.distributed`` world (ports
``kde_tpu/parallel/mesh.py:21-48``).

One process drives one device: a rank per GPU on the card (NCCL), a rank
per CPU process in the tests (gloo).  The framework's two scale axes keep
their names:

  * ``chains`` -- Gibbs chains, product samples and query points: purely
    data parallel (the reference runs them serially, src/MSGibbs01.jl:581);
  * ``kernels`` -- the mixture components of a density, sharded for very
    large component counts, with collective log-sum-exp and CDF reductions.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with those
dimension names that spans the whole initialized world.  Without a process
group every helper raises: nothing falls back to a single device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

CHAINS = "chains"
KERNELS = "kernels"


def world_size() -> int:
    """Size of the initialized world; raises without a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group: call "
            "kde_tpu_torch.parallel.initialize_multihost (or "
            "torch.distributed.init_process_group) on every rank first")
    return dist.get_world_size()


def _device_type() -> str:
    """NCCL worlds put a mesh on the GPUs; any other backend (gloo) on the
    host."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = CHAINS) -> DeviceMesh:
    """1-D mesh over the whole world; ``n_devices``, when given, must equal
    the world size."""
    n = world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh: n_devices={n_devices} but the world "
                         f"has {n} ranks (one device per rank)")
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(axis_name,))


def make_mesh_2d(shape: Tuple[int, int],
                 axis_names: Tuple[str, str] = (CHAINS, KERNELS)
                 ) -> DeviceMesh:
    """2-D mesh ``chains x kernels`` over the whole world (row-major: the
    ``kernels`` ranks of one chain row are consecutive)."""
    n = world_size()
    if shape[0] * shape[1] != n:
        raise ValueError(f"make_mesh_2d: shape {tuple(shape)} does not match "
                         f"the world's {n} ranks")
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Size of a mesh axis; an axis the mesh lacks has size 1."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on a mesh axis (0 on an axis the mesh
    lacks)."""
    return mesh.get_local_rank(axis) if axis in (mesh.mesh_dim_names or ()) \
        else 0


def chains_rows(mesh: DeviceMesh, n: int, axis_name: str = CHAINS) -> slice:
    """This rank's rows of an ``n``-row chain (sample, query) axis padded to
    a multiple of the axis size: the counterpart of ``chains_sharding``.
    Ranks along the other axes hold the same rows."""
    s = axis_size(mesh, axis_name)
    n_loc = pad_to_multiple(n, s) // s
    i = axis_index(mesh, axis_name)
    return slice(i * n_loc, (i + 1) * n_loc)
