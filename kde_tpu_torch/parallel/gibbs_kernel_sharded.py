"""Kernel/component-axis sharded Gibbs products (ports
``kde_tpu/parallel/gibbs_kernel_sharded.py:60-417``).

For very large densities the per-level candidate work and the level arrays
outgrow one device, so the component axis of every density is split over
the mesh's ``kernels`` ranks (SURVEY §5):

  * each rank holds only its contiguous shard of every level's candidates
    (each level's width padded to a multiple of the shard count; padded
    slots repeat the last valid node with a -inf log-weight);
  * chain state (selected means, variances, the sampled point) is
    replicated over ``kernels``: it is ``[ndens, d]`` per chain;
  * per selection, each rank scores its candidates, then
      - the degenerate test is a ``pmax`` of the local maxima and a
        ``psum`` of the shifted exp-sums against log(1e-99),
      - the global max is a ``pmax``, the shard totals an ``all_gather``,
      - the inverse-CDF index is an integer ``psum`` of the counts of CDF
        entries below the uniform draw (exact),
      - the winner's stats and label are a ``psum`` of the owner's values
        and zeros elsewhere (exact).

Every step is the single-device engine's arithmetic except the CDF, which
is (offset of the earlier shards + local cumsum) / total, the JAX package's
association, accumulated in float64; so labels can differ from the plain
engine only where a uniform draw lands within an ulp of a CDF boundary.
The local work between the collectives is ``ops/sharded_select.py``'s
phases (the port's K6): on the card with Euclidean or circular
differences its hand kernels, which keep no ``[chains, width]`` tensor, so
every chain runs in one block; on the CPU or with a user's ``diffop`` its
plain twins, counted in ``sharded_select.TWIN_STAGES`` (:func:`_route`).
Manifold hooks enter only the local arithmetic.  Chains may also be split
over a ``chains`` axis; the two axes compose.
"""

from __future__ import annotations

import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..density import KDE
from ..ops import gibbs as _g
from ..ops import sharded_select as _ss
from ..ops.balltree import n_levels as _n_levels
from ..utils.random import make_generator
from .collectives import all_gather, gather_rows, pmax, psum, shared_seed
from .mesh import (CHAINS, KERNELS, axis_index, axis_size, chains_rows,
                   pad_to_multiple)


class _KShardPlan:
    """One rank's shard of the per-level candidate arrays, in the
    shard-major layout ``[ndens, S, T_loc(, d)]`` of the JAX package with
    only row ``shard`` kept: ``lvl_mean``/``lvl_bw`` ``[1, dn, T_loc, d]``,
    ``lvl_logw`` ``[1, dn, T_loc]`` and ``lvl_stats`` ``[1, dn, T_loc,
    2d+1]`` (mean, variance and original label in float64, the payload of
    the winner's ``psum``).  Level ``l`` is the local slice
    ``offsets[l-1]``, at the same offset on every rank; ``lvl_real [L,
    dn]`` says whether the shard holds a real (not padded) candidate of
    each density at each level, and ``lvl_uniform [L, dn, d]`` whether
    every candidate of the shard's slice of a level has the same bandwidth
    in a dim (``sharded_select.uniform_dims``, taken once here: K6 then
    takes ``log c`` once a row there).  The roots' ``t_mean``/``t_bw``
    ``[1, dn, 1, d]`` are replicated."""

    def __init__(self, densities: Sequence[KDE], n_out: int, dtype,
                 n_shards: int, shard: int, device):
        self.ndens = len(densities)
        dims = {p.ndim for p in densities}
        if len(dims) != 1:
            raise ValueError("kdes must have same dimension "
                             "(reference src/MSGibbs01.jl:721)")
        self.ndim = dims.pop()
        self.n_levels = _n_levels(n_out, [p.npts for p in densities])
        trees = [p.tree for p in densities]
        dn, d, S = self.ndens, self.ndim, n_shards
        per_tree = [t.level_lists(self.n_levels) for t in trees]
        self.offsets: List[Tuple[int, int]] = []
        t_loc = 0
        for l in range(1, self.n_levels + 1):
            w = max(len(per_tree[j][l]) for j in range(dn))
            w_loc = pad_to_multiple(max(w, 1), S) // S
            self.offsets.append((t_loc, w_loc))
            t_loc += w_loc
        mean = np.zeros((dn, t_loc, d))
        bw = np.ones((dn, t_loc, d))
        logw = np.full((dn, t_loc), -np.inf)
        perm = np.zeros((dn, t_loc))
        real = np.zeros((self.n_levels, dn), dtype=bool)
        for l in range(1, self.n_levels + 1):
            o, w_loc = self.offsets[l - 1]
            lo = shard * w_loc
            for j, t in enumerate(trees):
                lst = list(per_tree[j][l])
                nv = len(lst)
                # padded slots repeat the last valid node (-inf logw): a
                # CDF tail overflow selects the reference's fall-to-last
                full = np.asarray(lst + [lst[-1]] * (S * w_loc - nv))
                nodes = full[lo:lo + w_loc]
                mean[j, o:o + w_loc] = t.means[nodes]
                bw[j, o:o + w_loc] = t.bandwidth[nodes]
                lw = np.full(S * w_loc, -np.inf)
                lw[:nv] = np.log(np.maximum(t.weights[lst], 1e-300))
                logw[j, o:o + w_loc] = lw[lo:lo + w_loc]
                real[l - 1, j] = lo < nv
                perm[j, o:o + w_loc] = t.permutation[nodes]
        dev = lambda x: torch.as_tensor(x, dtype=dtype, device=device)[None]
        self.lvl_mean = dev(mean)
        self.lvl_bw = dev(bw)
        self.lvl_logw = dev(logw)
        self.lvl_stats = torch.cat(
            [self.lvl_mean.double(), self.lvl_bw.double(),
             torch.as_tensor(perm, dtype=torch.float64,
                             device=device)[None, ..., None]], dim=-1)
        self.lvl_real = torch.as_tensor(real, device=device)
        self.lvl_uniform = torch.stack([_ss.uniform_dims(
            self.lvl_bw[0, :, o:o + w]) for o, w in self.offsets])
        # the trees' roots, [1, dn, 1, d]: ``_run_chain`` reads slot 0
        self.t_mean = dev(np.stack([t.means[:1] for t in trees]))
        self.t_bw = dev(np.stack([t.bandwidth[:1] for t in trees]))

    def level(self, l: int):
        """Level ``l`` (1-based): this shard's mean/bw ``[1, dn, w, d]``,
        logw ``[1, dn, w]``, stats ``[1, dn, w, 2d+1]``, real ``[dn]`` and
        uniform ``[dn, d]``."""
        o, w = self.offsets[l - 1]
        return (self.lvl_mean[:, :, o:o + w], self.lvl_bw[:, :, o:o + w],
                self.lvl_logw[:, :, o:o + w], self.lvl_stats[:, :, o:o + w],
                self.lvl_real[l - 1], self.lvl_uniform[l - 1])

    def level_uniform(self, l: int) -> torch.Tensor:
        """Level ``l``'s uniform flags with the set axis, ``[1, dn, d]``
        (``_run_chain`` puts them on its stages; the sharded selection
        reads them from :meth:`level`)."""
        return self.lvl_uniform[l - 1][None]


# Shard plans keyed by the densities' identity, the level count, dtype, the
# shard count, this rank's shard and its device; an entry is evicted when
# any of its densities is collected.
_ks_plan_cache: dict = {}


def _get_ks_plan(densities: Sequence[KDE], n_out: int, dtype, n_shards: int,
                 shard: int, device) -> _KShardPlan:
    npts = tuple(p.npts for p in densities)
    key = (tuple(id(p) for p in densities), npts, _n_levels(n_out, npts),
           str(dtype), n_shards, shard, str(device))
    hit = _ks_plan_cache.get(key)
    if hit is not None:
        return hit
    plan = _KShardPlan(densities, n_out, dtype, n_shards, shard, device)
    _ks_plan_cache[key] = plan

    def _evict(key=key):
        _ks_plan_cache.pop(key, None)
    for p in densities:
        weakref.finalize(p, _evict)
    return plan


# ---------------------------------------------------------------------------
# sharded selection
# ---------------------------------------------------------------------------

def _route(hooks, device, d: int) -> str:
    """Where the selections' local work runs: ``sharded`` (K6's kernels)
    on the card when every dim's difference is Euclidean or circular,
    ``twin`` (their plain twins) on the CPU or with a user's ``diffop``."""
    if (torch.device(device).type == "cuda"
            and _ss.diff_codes((hooks or _g._NO_HOOKS)[1], d) is not None):
        return "sharded"
    return "twin"


# the phases of a selection, in the order the collectives separate them
_PHASES = ("local_max", "shifted_sum", "dead_max", "exp_sum", "count_below",
           "owner_stats")


def _sharded_choose(mesh: DeviceMesh, d: int, route: str):
    """The selection step of ``ops/gibbs.py::_run_chain`` with the
    candidates sharded over ``kernels``
    (``kde_tpu/parallel/gibbs_kernel_sharded.py:158-187`` and the one-hot
    stats of ``:190-283``, step for step): the densities of ``js`` are
    selected in one batch of six collectives (all ``dn`` of them in the
    conditioning step) around the local phases of
    ``ops/sharded_select.py``, on ``route`` (:func:`_route`):

      (1) the degenerate predicate sum(exp(logits)) < 1e-99 as a ``pmax``
          of the local maxima and a ``psum`` of the shifted exp-sums;
      (2) the uniform fallback over real candidates, and (3) the global
          max, a ``pmax``;
      (4) the shard totals, an ``all_gather``;
      (5) the global index, an integer ``psum`` of the counts of CDF
          entries (offset + local cumsum) / total below u;
      (6) the winner's mean, variance and label, a ``psum`` of the owner's
          float64 stats (zeros on the other shards), exact.

    On the ``sharded`` route the stage's rows are checked and packed once
    (``sharded_select.prepare``, with the level's uniform flags) before
    the phases launch."""
    s = axis_size(mesh, KERNELS)
    sid = axis_index(mesh, KERNELS)
    f = [getattr(_ss, name if route == "sharded" else name + "_ref")
         for name in _PHASES]
    local_max, shifted_sum, dead_max, exp_sum, count_below, owner_stats = f

    def choose(stage, lvl):
        if route != "sharded":
            _ss.TWIN_STAGES += 1
        js = tuple(stage.js)
        mean, bw, logw, stats, real, uniform = lvl
        rows = _ss.Rows(mean[0], bw[0], logw[0], js, stage.mu[0],
                        None if stage.cov is None else stage.cov[0],
                        stage.active[0], stage.diffop)
        if route == "sharded":
            rows = _ss.prepare(rows, uniform)
        m = local_max(rows)
        m0 = pmax(m, mesh, KERNELS)
        ssum = psum(shifted_sum(rows, m0), mesh, KERNELS)
        dead, mfb = dead_max(m0, ssum, m, real[js[0]:js[-1] + 1])
        gmax = pmax(mfb, mesh, KERNELS)
        tots = all_gather(exp_sum(rows, gmax, dead), mesh, KERNELS)
        z = psum(count_below(rows, gmax, dead, tots, sid, stage.u[0]), mesh,
                 KERNELS)
        del rows           # the stage's scratch is free for the stats
        sel = psum(owner_stats(stats[0], js, z, s, sid), mesh, KERNELS)
        dt = logw.dtype
        mv, label = sel[..., :2 * d].to(dt), sel[..., 2 * d].to(torch.int64)
        return [(mv[jj:jj + 1, :, :d], mv[jj:jj + 1, :, d:],
                 label[jj:jj + 1]) for jj in range(len(js))]
    return choose


def prod_appx_ms_gibbs_kernel_sharded(mesh: DeviceMesh,
                                      n_out: int,
                                      densities: Sequence[KDE],
                                      n_iter: int = 3,
                                      add_entropy: bool = True,
                                      partial_dim_mask=None,
                                      key=None,
                                      rand_u: Optional[np.ndarray] = None,
                                      rand_n: Optional[np.ndarray] = None,
                                      record_labels: bool = False,
                                      dtype=None,
                                      addop=None,
                                      diffop=None,
                                      get_mu=None,
                                      get_lambda=None):
    """Gibbs product with every density's component axis split over
    ``mesh``'s ``kernels`` axis, and the chains over its ``chains`` axis when
    it has one.  Arguments and returns are those of
    :func:`kde_tpu_torch.prod_appx_ms_gibbs` (flat inverse-CDF selection);
    injected ``rand_u``/``rand_n`` streams replay the serial reference
    trace.  Keyed streams are drawn as the unsharded keyed call draws them
    (``key``: an int, or a generator / ``None`` from which rank 0 draws
    the shared seed).

    Manifold hooks: pass them explicitly, or none to collect the
    densities' own hooks with ``product()``'s consistency rule (mixed
    quadruples raise ``ValueError``).  Every rank passes the same
    densities; each keeps only its shard of the level arrays on its
    device.  Returns the gathered ``(points [d, n_out], indices
    [ndens, n_out])`` (and labels ``[n_out, ndens, L]`` with
    ``record_labels``) on the densities' device."""
    if KERNELS not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh must have a '{KERNELS}' axis; got "
                         f"{mesh.mesh_dim_names}")
    densities = list(densities)
    device = densities[0].device
    dtype = dtype or densities[0].dtype
    if all(h is None for h in (addop, diffop, get_mu, get_lambda)):
        addop, diffop, get_mu, get_lambda = _g._density_hooks(densities)
    hooks = _g.normalize_hooks(addop, diffop, get_mu, get_lambda,
                               densities[0].ndim)
    if (rand_u is None) != (rand_n is None):
        raise ValueError("replay mode needs BOTH streams: pass rand_u and "
                         "rand_n together")
    plan = _get_ks_plan(densities, n_out, dtype, axis_size(mesh, KERNELS),
                        axis_index(mesh, KERNELS), device)
    dn, d = plan.ndens, plan.ndim
    mask = _g._mask_tensor(partial_dim_mask, dn, d, device)[None]
    bu, bn = _g._stream_sizes(dn, d, plan.n_levels, n_iter)
    if rand_u is None:
        gen = make_generator(shared_seed(key, device), device)
        u, nrm, _ = _g._keyed_streams(gen, n_out, bu, bn, dtype, device,
                                      "cdf")
    else:
        stream = lambda r, k: torch.as_tensor(
            np.asarray(r, dtype=np.float64).ravel()[:n_out * k]
            .reshape(n_out, k), dtype=dtype, device=device)
        u, nrm = stream(rand_u, bu), stream(rand_n, bn)
    n_pad = pad_to_multiple(n_out, axis_size(mesh, CHAINS))
    u = torch.nn.functional.pad(u, (0, 0, 0, n_pad - n_out), value=0.5)
    nrm = torch.nn.functional.pad(nrm, (0, 0, 0, n_pad - n_out))
    rows = chains_rows(mesh, n_out)
    # chain blocks sized from the local width, the local chain count and
    # the route, which are the same on every rank: every rank runs the
    # same collectives
    route = _route(hooks, device, d)
    pts, idx, labels = (t[0] for t in _g._gibbs_all_chains(
        u[None, rows], nrm[None, rows], plan, mask, n_iter, add_entropy,
        hooks=hooks, choose=_sharded_choose(mesh, d, route), route=route))
    out = (gather_rows(pts, mesh, CHAINS, n_out).T,
           gather_rows(idx, mesh, CHAINS, n_out).T)
    if record_labels:
        out = out + (gather_rows(labels, mesh, CHAINS, n_out)
                     .transpose(1, 2),)
    return out
