"""Product memory sizing and engine routing (ports
``kde_tpu/parallel/sizing.py:30-91``).

The plain engine holds every density's whole level plan and one chain
block's ``[chains, leaf width]`` selection temporaries on one device; the
kernel-sharded engine (gibbs_kernel_sharded.py) splits the component axis
``S`` ways, so it pays only when a product does not fit one device:

    S = ceil(product_bytes / budget);  S == 1 -> the plain engine.

Torch has no ahead-of-time memory analysis, so ``product_bytes`` is an
analytic model of the port's keyed product (:func:`estimate_product_memory`),
checked on the card against ``torch.cuda.max_memory_allocated``
(chip_smoke.py phase 11).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..ops import gibbs as _g
from ..ops.balltree import n_levels
from ..ops.device_plan import build_bytes, level_widths

# Share of a CUDA device's memory a product may take: the rest is left to
# the densities themselves, other resident tensors and allocator slack.
HBM_BUDGET_SHARE = 0.75


def estimate_product_memory(densities: Sequence, n_out: int,
                            n_iter: int = 5, dtype=torch.float32,
                            select: str = "auto") -> dict:
    """Bytes of the keyed product ``prod_appx_ms_gibbs`` runs for
    ``densities`` at ``n_out`` chains (:func:`product_bytes` of their
    shapes, the plan builder ``plan="auto"`` picks, their device and
    hooks).  The plan is sized from the shapes alone: nothing is built,
    cached or allocated on the densities' device."""
    densities = list(densities)
    dims = {p.ndim for p in densities}
    if len(dims) != 1:
        raise ValueError("kdes must have same dimension "
                         "(reference src/MSGibbs01.jl:721)")
    d = dims.pop()
    return product_bytes(tuple(p.npts for p in densities), d, n_out,
                         n_iter, dtype, select,
                         _g._resolve_plan_impl(densities, "auto",
                                               replay=False),
                         densities[0].device,
                         _g.normalize_hooks(*_g._density_hooks(densities),
                                            d))


def product_bytes(npts: Sequence[int], d: int, n_out: int, n_iter: int = 5,
                  dtype=torch.float32, select: str = "auto",
                  plan: str = "host", device="cuda", hooks=None) -> dict:
    """Bytes of a keyed product of densities of ``npts`` points in ``d``
    dims at ``n_out`` chains, its level plan built by ``plan`` (host or
    device) on ``device``, with the normalized ``hooks`` (None:
    Euclidean): ``args`` (the level plan's tensors with its uniform-level
    flags, the mask and, for a plan built on the device, its topology
    cache and build workspace, ``device_plan.build_bytes``), ``temp`` (the
    uniform and normal streams, no uniforms but the counter seed for
    ``gumbel``, twice: each set's draw and their stacked copy,
    ``ops/gibbs.py::_gibbs_keyed``; the ``[block, widest level]``
    temporaries one chain block keeps alive on the selection's route,
    ``ops/gibbs.py::_live_temps``, none on the kernels; off the chain
    route, two more copies of the outputs: the per-level label clones and
    the concatenation of the blocks), ``out`` (points and per-level
    labels, of which the returned labels are a view on the chain route)
    and their ``total``, with the ``select`` mode the call resolves to.
    Counted from the shapes alone, at any N."""
    npts = tuple(int(n) for n in npts)
    dn = len(npts)
    # host and device plans pack the same data-independent levels
    n_lv = n_levels(n_out, npts)
    widths = [max(ws) for ws in zip(*(level_widths(n, n_lv) for n in npts))]
    sel = _g.resolve_select(select, n_out, widths[-1])
    item = torch.empty((), dtype=dtype).element_size()
    nodes = dn * sum(widths)
    # t_mean, t_bw [dn, 2N, d]; lvl_mean, lvl_bw [dn, T, d]; lvl_logw
    # [dn, T]; lvl_perm [dn, T] int64 (ops/gibbs.py::_PLAN_TENSORS);
    # lvl_uniform [dn, L, d] uint8; the mask [dn, d] bool
    args = (2 * dn * 2 * max(npts) * d * item + nodes * (2 * d + 1) * item
            + nodes * 8 + dn * n_lv * d + dn * d)
    if plan == "device":
        args += build_bytes(npts, d, item, nodes, device)
    bu, bn = _g._stream_sizes(dn, d, n_lv, n_iter)
    streams = (n_out * bn * item + 16 if sel == "gumbel"
               else n_out * (bu + bn) * item)
    route = _g._route(sel, hooks, device, dn, d)
    live = _g._live_temps(route)
    widest = max(widths)
    out = n_out * (d * item + n_lv * dn * 8)
    temp = (2 * streams
            + live * widest * item * _g._chains_per_block(n_out, widest, item,
                                                          live)
            + (0 if route == "chain" else 2 * out))
    return {"args": int(args), "temp": int(temp), "out": int(out),
            "total": int(args + temp + out), "select": sel}


def default_hbm_budget(device) -> int:
    """``HBM_BUDGET_SHARE`` of a CUDA device's memory; other devices have
    no default."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no default memory budget for a {device.type} "
                         "device: pass hbm_budget=")
    return int(HBM_BUDGET_SHARE
               * torch.cuda.get_device_properties(device).total_memory)


def recommend_shards(densities: Sequence, n_out: int, n_iter: int = 5,
                     dtype=torch.float32,
                     hbm_budget: Optional[int] = None,
                     mem: Optional[dict] = None) -> dict:
    """The routing rule: ``{"shards", "engine", "bytes", "budget",
    "select"}``, ``engine`` ``"plain"`` when the product fits the budget
    (``shards == 1``), else ``"kernel-sharded"`` with
    ``shards = ceil(bytes / budget)``.  ``hbm_budget`` defaults to
    :func:`default_hbm_budget` of the densities' device; pass ``mem`` (from
    :func:`estimate_product_memory`) to reuse an estimate."""
    if mem is None:
        mem = estimate_product_memory(densities, n_out, n_iter=n_iter,
                                      dtype=dtype)
    if hbm_budget is None:
        hbm_budget = default_hbm_budget(list(densities)[0].device)
    shards = max(1, math.ceil(mem["total"] / hbm_budget))
    return {"shards": shards,
            "engine": "plain" if shards == 1 else "kernel-sharded",
            "bytes": mem["total"], "budget": int(hbm_budget),
            "select": mem["select"]}
