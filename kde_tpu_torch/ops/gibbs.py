"""Approximate products of KDEs by multiscale Gibbs sampling (ports
``kde_tpu/ops/gibbs.py:59-139, 182-264, 267-354, 498-651, 692-818,
821-912, 1138-1189``; algorithm: Ihler, Sudderth, Freeman & Willsky,
"Efficient multiscale sampling from products of Gaussian mixtures",
NIPS 2003; reference src/MSGibbs01.jl).

Every output sample is an independent chain.  All chains walk the same
level schedule, precomputed on the host from the densities' ball trees into
dense padded per-level arrays of node (mean, variance, weight).  At each
level a chain (1) draws X from the product of its current selections,
(2) re-selects one label per density conditioned on X, and (3) runs
``n_iter`` sweeps of leave-one-out Gibbs over the densities; a final draw
ends the chain.  :func:`_run_chain` runs a block of chains at once, with
the chain batch written out as the leading tensor dimension.

All randomness is drawn up front per chain: ``bu = dn*(1 + L*(1+n_iter))``
uniforms and ``bn = d*(L+1)`` normals, in the reference's consumption order
(its ``randU``/``randN`` buffers, src/MSGibbs01.jl:661-662).  Injected
streams therefore replay a serial trace exactly ("replay mode").  Keyed
draws come from an explicit ``torch.Generator``.

Numerical guards kept from the reference: per-dimension NaN suppression
(:302-304), the degenerate fallback to a uniform draw when the candidate
likelihood total is below 1e-99 (:311-315, tested in log space), and
partial-dimension information zeroing (:189-209).  Euclidean only
(manifold hooks are ROADMAP M8).
"""

from __future__ import annotations

import math
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import manifolds
from ..density import KDE, kde
from ..utils.random import make_generator

# Budget for the live [chains, level width] temporaries of one chain block.
# Chains are i.i.d. given their stream rows, so blocking is layout only.
CHAIN_BLOCK_BYTES: int = 2 << 30

# about this many [chains, width] temporaries are alive at once
_LIVE_TEMPS = 8

# log(1e-99): the reference's degenerate-likelihood threshold
# (src/MSGibbs01.jl:311, `cmo.pT < 1e-99`)
_LOG_DEAD = float(np.log(1e-99))


# ---------------------------------------------------------------------------
# host-side precompute
# ---------------------------------------------------------------------------

class _ProductPlan:
    """Dense, padded per-level arrays for a set of densities, built on the
    host in NumPy and moved to ``device``."""

    def __init__(self, densities: Sequence[KDE], n_out: int, dtype, device):
        self.ndens = len(densities)
        dims = {p.ndim for p in densities}
        if len(dims) != 1:
            raise ValueError("kdes must have same dimension "
                             "(reference src/MSGibbs01.jl:721)")
        self.ndim = dims.pop()
        npts = [p.npts for p in densities]
        self.n_levels = _n_levels(n_out, npts)

        trees = [p.tree for p in densities]
        two_n = 2 * max(npts)
        dn, d = self.ndens, self.ndim
        t_mean = np.zeros((dn, two_n, d))
        t_bw = np.ones((dn, two_n, d))
        t_wt = np.zeros((dn, two_n))
        t_perm = np.zeros((dn, two_n), dtype=np.int64)
        for j, t in enumerate(trees):
            s = 2 * t.num_points
            t_mean[j, :s] = t.means
            t_bw[j, :s] = t.bandwidth
            t_wt[j, :s] = t.weights
            t_perm[j, :s] = t.permutation

        # per-level node lists (levels 1..L), padded across densities and
        # packed along one node axis; level l is the slice offsets[l-1]
        per_tree = [t.level_lists(self.n_levels) for t in trees]
        widths = [max(len(per_tree[j][l]) for j in range(dn))
                  for l in range(self.n_levels + 1)]
        self.offsets: List[Tuple[int, int]] = []
        total = 0
        for l in range(1, self.n_levels + 1):
            self.offsets.append((total, widths[l]))
            total += widths[l]
        nodes = np.zeros((dn, total), dtype=np.int64)
        valid = np.zeros((dn, total), dtype=bool)
        for l in range(1, self.n_levels + 1):
            o, w = self.offsets[l - 1]
            for j in range(dn):
                lst = per_tree[j][l]
                nodes[j, o:o + len(lst)] = lst
                valid[j, o:o + len(lst)] = True
                # padded slots repeat the last valid node (with -inf
                # log-weight): a CDF tail that overflows into the padding
                # selects the last valid node, the reference's
                # fall-to-last-entry rule (src/MSGibbs01.jl:330-351)
                nodes[j, o + len(lst):o + w] = lst[-1]
        idx_j = np.arange(dn)[:, None]
        lvl_logw = (np.log(np.maximum(t_wt[idx_j, nodes], 1e-300))
                    + np.where(valid, 0.0, -np.inf))

        dev = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        self.t_mean = dev(t_mean)                            # [dn, 2N, d]
        self.t_bw = dev(t_bw)
        self.lvl_mean = dev(t_mean[idx_j, nodes])            # [dn, T, d]
        self.lvl_bw = dev(t_bw[idx_j, nodes])
        self.lvl_logw = dev(lvl_logw)                        # [dn, T]
        self.lvl_perm = torch.as_tensor(t_perm[idx_j, nodes], device=device)

    def level(self, l: int):
        """Views of level ``l`` (1-based): mean/bw ``[dn, w, d]``, logw and
        perm ``[dn, w]``."""
        o, w = self.offsets[l - 1]
        return (self.lvl_mean[:, o:o + w], self.lvl_bw[:, o:o + w],
                self.lvl_logw[:, o:o + w], self.lvl_perm[:, o:o + w])


def _n_levels(n_out: int, npts: Sequence[int]) -> int:
    """Nlevels = floor(log2(maxNp)) + 1 (reference src/MSGibbs01.jl:660)."""
    max_np = max([n_out] + list(npts))
    return int(math.floor(math.log(float(max_np)) / math.log(2.0)) + 1.0)


# Plan cache keyed by the identity of the densities and the level, dtype and
# device configuration; an entry is evicted when any of its densities is
# collected.
_plan_cache: dict = {}


def _get_plan(densities: Sequence[KDE], n_out: int, dtype,
              device) -> _ProductPlan:
    key = (tuple(id(p) for p in densities), tuple(p.npts for p in densities),
           _n_levels(n_out, [p.npts for p in densities]), str(dtype),
           str(device))
    hit = _plan_cache.get(key)
    if hit is not None:
        return hit
    plan = _ProductPlan(densities, n_out, dtype, device)
    _plan_cache[key] = plan

    def _evict(key=key):
        _plan_cache.pop(key, None)
    for p in densities:
        weakref.finalize(p, _evict)
    return plan


# ---------------------------------------------------------------------------
# chain-batched primitives; C = chains in the block
# ---------------------------------------------------------------------------

def _gauss_product(mu_sel, var_sel, mask, skip: int):
    """Information-form product of the selected kernels over densities
    (reference gaussianProductMeanCov!, src/MSGibbs01.jl:176-216).

    ``mu_sel``/``var_sel`` ``[C, dn, d]`` (zeroed at inactive dims),
    ``mask [dn, d]``, ``skip``: density left out, or -1.  Returns
    ``(mu, cov)``, ``[C, d]`` each, zero where no density contributes."""
    dn = mask.shape[0]
    keep = torch.arange(dn, device=mask.device)[:, None] != skip
    contrib = mask & keep                                     # [dn, d]
    pos = var_sel > 0
    lam = torch.where(contrib & pos,
                      1.0 / torch.where(pos, var_sel, torch.ones_like(var_sel)),
                      torch.zeros_like(var_sel))
    has = contrib.any(dim=0)                                  # [d]
    lam_tot = lam.sum(dim=1)                                  # [C, d]
    cov = torch.where(has, 1.0 / torch.where(has, lam_tot,
                                             torch.ones_like(lam_tot)),
                      torch.zeros_like(lam_tot))
    mu = cov * (lam * mu_sel).sum(dim=1)
    return mu, cov


def _kernel_logits_raw(lvl_mean_j, lvl_bw_j, lvl_logw_j, mu, cov, active_dim):
    """Candidate log-likelihoods ``[C, w]`` of one density's level nodes
    (``lvl_mean_j``/``lvl_bw_j`` ``[w, d]``, ``lvl_logw_j [w]``) against a
    Gaussian of mean ``mu [C, d]`` and covariance ``bw + cov`` (``cov``
    ``[C, d]`` or None), without the degenerate fallback (reference
    makeFasterSampleIndex!, src/MSGibbs01.jl:250-328)."""
    acc = None
    for k in range(lvl_mean_j.shape[1]):
        if not bool(active_dim[k]):           # partial-dim skip (:281-285)
            continue
        c = lvl_bw_j[None, :, k]
        if cov is not None:
            c = c + cov[:, k:k + 1]
        delta = lvl_mean_j[None, :, k] - mu[:, k:k + 1]
        per_dim = delta * delta / c + torch.log(c)
        per_dim = torch.nan_to_num(per_dim, nan=0.0, posinf=math.inf,
                                   neginf=-math.inf)   # NaN suppression
        acc = per_dim if acc is None else acc + per_dim
    if acc is None:
        acc = torch.zeros((mu.shape[0], lvl_mean_j.shape[0]),
                          dtype=mu.dtype, device=mu.device)
    logits = lvl_logw_j[None, :] - 0.5 * acc
    return logits.nan_to_num(nan=-math.inf, posinf=math.inf,
                             neginf=-math.inf)


def _dead_predicate(logits):
    """``[C]``: True iff ``sum(exp(logits)) < 1e-99``, the log-space form of
    the reference's linear-f64 degenerate test (src/MSGibbs01.jl:311).  The
    safe shift makes an all -inf row dead."""
    m = logits.max(dim=1).values
    ms = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    lse = ms + torch.log(torch.exp(logits - ms[:, None]).sum(dim=1))
    return lse < _LOG_DEAD


def _apply_dead_fallback(logits, lvl_logw_j, dead):
    """Where ``dead``, draw uniformly over the real candidate nodes
    (reference src/MSGibbs01.jl:311-315): 0 for real candidates, -inf for
    padding."""
    fallback = torch.where(torch.isneginf(lvl_logw_j),
                           torch.full_like(lvl_logw_j, -math.inf),
                           torch.zeros_like(lvl_logw_j))
    return torch.where(dead[:, None], fallback[None, :], logits)


def _kernel_logits(lvl_mean_j, lvl_bw_j, lvl_logw_j, mu, cov, active_dim):
    """:func:`_kernel_logits_raw` with the degenerate fallback applied."""
    logits = _kernel_logits_raw(lvl_mean_j, lvl_bw_j, lvl_logw_j, mu, cov,
                                active_dim)
    return _apply_dead_fallback(logits, lvl_logw_j, _dead_predicate(logits))


def _select_label(u, logits):
    """Inverse-CDF draw, ``[C]`` labels from uniforms ``u [C]`` and
    ``logits [C, w]``: the count of CDF entries below ``u``, i.e. the first
    index whose CDF reaches ``u`` (reference selectLabelOnLevel,
    src/MSGibbs01.jl:330-351, accepting on ``u <= cdf``).  The
    probabilities are normalized *before* the cumulative sum, as in the
    reference and the serial oracle, so replayed labels flip only where
    they would there."""
    e = torch.exp(logits - logits.max(dim=1, keepdim=True).values)
    cdf = torch.cumsum(e / e.sum(dim=1, keepdim=True), dim=1)
    z = (cdf < u[:, None]).sum(dim=1)
    return z.clamp(0, logits.shape[1] - 1)


def _sample_point(mu_sel, var_sel, mask, normals, jitter: bool):
    """Draw ``[C, d]`` from the product of the current selections
    (reference samplePoint!, src/MSGibbs01.jl:440-463)."""
    mu, cov = _gauss_product(mu_sel, var_sel, mask, -1)
    return mu + torch.sqrt(cov) * normals if jitter else mu


def _run_chain(u, nrm, plan: _ProductPlan, mask, n_iter: int,
               add_entropy: bool):
    """A block of chains.  ``u [C, bu]`` and ``nrm [C, bn]`` are their
    streams in the reference's consumption order:

      uniforms: [dn init] ++ per level ([dn cond] ++ [n_iter*dn gibbs])
      normals:  [(L+1) * d]

    Returns ``points [C, d]``, final labels ``[C, dn]`` and per-level
    labels ``[C, L, dn]`` (0-based original point indices).  The
    reference's ``levelDown!`` label remap (:512-513) is left out: the
    conditioning re-selection overwrites it before any read."""
    c = u.shape[0]
    dn, d, L = plan.ndens, plan.ndim, plan.n_levels
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    # dims carried by at least one OTHER density (the LOO dimmask,
    # reference src/MSGibbs01.jl:270-275)
    union_other = torch.stack([
        torch.cat([mask[:j], mask[j + 1:]]).any(dim=0) for j in range(dn)])
    act_all = (mask & union_other).cpu()
    per_level = u[:, dn:].reshape(c, L, (1 + n_iter) * dn)
    u_cond = per_level[:, :, :dn]
    u_gibbs = per_level[:, :, dn:].reshape(c, L, n_iter, dn)
    normals = nrm.reshape(c, L + 1, d)

    # initial selection: every tree's root (reference src/MSGibbs01.jl:89-107)
    mu_sel = torch.where(mask, plan.t_mean[:, 0, :], zero).expand(c, dn, d)
    var_sel = torch.where(mask, plan.t_bw[:, 0, :], zero).expand(c, dn, d)
    mu_sel, var_sel = mu_sel.contiguous(), var_sel.contiguous()
    perms = torch.zeros((c, dn), dtype=torch.int64, device=u.device)
    labels = []

    def pick(j, z, lvl_mean, lvl_bw, lvl_perm):
        mu_sel[:, j] = torch.where(mask[j], lvl_mean[j][z], zero)
        var_sel[:, j] = torch.where(mask[j], lvl_bw[j][z], zero)
        perms[:, j] = lvl_perm[j][z]

    for l in range(1, L + 1):
        lvl_mean, lvl_bw, lvl_logw, lvl_perm = plan.level(l)
        # (1) draw X from the product of the current selections (:594)
        x = _sample_point(mu_sel, var_sel, mask, normals[:, l - 1], True)
        # (2) re-select every density's label conditioned on X (:600)
        zs = [_select_label(u_cond[:, l - 1, j],
                            _kernel_logits(lvl_mean[j], lvl_bw[j],
                                           lvl_logw[j], x, None, act_all[j]))
              for j in range(dn)]
        for j in range(dn):
            pick(j, zs[j], lvl_mean, lvl_bw, lvl_perm)
        # (3) n_iter sweeps of sequential LOO Gibbs over densities (:604-608)
        for t in range(n_iter):
            for j in range(dn):
                mu, cov = _gauss_product(mu_sel, var_sel, mask, j)
                logits = _kernel_logits(lvl_mean[j], lvl_bw[j], lvl_logw[j],
                                        mu, cov, act_all[j])
                pick(j, _select_label(u_gibbs[:, l - 1, t, j], logits),
                     lvl_mean, lvl_bw, lvl_perm)
        labels.append(perms.clone())

    # final draw (:612-625)
    x = _sample_point(mu_sel, var_sel, mask, normals[:, L], add_entropy)
    return x, labels[-1], torch.stack(labels, dim=1)


def _chain_block(n_out: int, plan: _ProductPlan, itemsize: int) -> int:
    """Chains per block so the live temporaries stay within
    ``CHAIN_BLOCK_BYTES``."""
    width = max(w for _, w in plan.offsets)
    per_chain = _LIVE_TEMPS * width * itemsize
    return max(1, min(n_out, CHAIN_BLOCK_BYTES // per_chain))


def _gibbs_all_chains(u, nrm, plan: _ProductPlan, mask, n_iter: int,
                      add_entropy: bool):
    """All chains, in blocks of :func:`_chain_block` chains."""
    n_out = u.shape[0]
    block = _chain_block(n_out, plan, u.element_size())
    outs = [_run_chain(u[s:s + block], nrm[s:s + block], plan, mask,
                       n_iter, add_entropy)
            for s in range(0, n_out, block)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _resolve_select(select: str) -> None:
    if select in ("auto", "cdf"):
        return
    if select in ("blocked", "gumbel"):
        raise NotImplementedError(
            f"select={select!r} is not ported yet (ROADMAP M10); the port "
            "draws labels with the flat inverse CDF ('cdf')")
    raise ValueError(f"select must be auto|cdf|blocked|gumbel, got {select!r}")


def _stream_sizes(dn: int, d: int, n_levels: int, n_iter: int):
    return dn * (1 + n_levels * (1 + n_iter)), d * (n_levels + 1)


def _keyed_streams(key, n_out: int, bu: int, bn: int, dtype, device):
    """Uniform ``[n_out, bu]`` and normal ``[n_out, bn]`` streams from the
    generator of ``key``; chain ``i`` consumes row ``i`` of each."""
    g = make_generator(key, device)
    u = torch.rand((n_out, bu), generator=g, dtype=dtype, device=device)
    nrm = torch.randn((n_out, bn), generator=g, dtype=dtype, device=device)
    return u, nrm


def _mask_tensor(partial_dim_mask, dn: int, d: int, device):
    if partial_dim_mask is None:
        return torch.ones((dn, d), dtype=torch.bool, device=device)
    return torch.as_tensor(np.asarray(partial_dim_mask, dtype=bool)
                           .reshape(dn, d), device=device)


def prod_appx_ms_gibbs(npd0,
                       densities: Sequence[KDE],
                       an_fcns=None,
                       an_params=None,
                       n_iter: int = 3,
                       addop=None,
                       diffop=None,
                       get_mu=None,
                       get_lambda=None,
                       add_entropy: bool = True,
                       partial_dim_mask: Optional[Sequence] = None,
                       rand_u: Optional[np.ndarray] = None,
                       rand_n: Optional[np.ndarray] = None,
                       record_labels: bool = False,
                       key=None,
                       dtype=None,
                       select: str = "auto"):
    """Draw samples from (an approximation of) the product of ``densities``
    (reference prodAppxMSGibbsS, src/MSGibbs01.jl:645-703).

    Args:
      npd0: a KDE whose ``npts`` is the number of samples, or an int.
      densities: the KDEs to multiply, all on one device.
      an_fcns/an_params: accepted for API compatibility (ignored, as in the
        reference, :678).
      n_iter: Gibbs sweeps per level (reference Niter).
      addop/diffop/get_mu/get_lambda: manifold hooks; only the Euclidean
        defaults are ported (ROADMAP M8).
      add_entropy: if False, each output is the product-Gaussian mean of
        the selected kernels (:455-459).
      partial_dim_mask: ``[ndens][d]`` booleans, the dims each density
        carries information on (:663).
      rand_u/rand_n: injected uniform and normal streams in the reference's
        consumption order ("replay mode", :691-695); otherwise ``key`` (a
        ``torch.Generator``, an int seed or None for the module generator).
      record_labels: also return the per-level labels.
      dtype: float type of the chains (default: the densities').
      select: ``auto``/``cdf``, the flat inverse-CDF draw; ``blocked`` and
        ``gumbel`` are ROADMAP M10.

    Returns ``(points [d, Np], indices [ndens, Np])`` with 0-based labels,
    plus ``labels [Np, ndens, n_levels]`` if ``record_labels``.
    """
    del an_fcns, an_params
    _resolve_select(select)
    n_out = npd0 if isinstance(npd0, int) else npd0.npts
    densities = list(densities)
    device = densities[0].device
    if any(p.device != device for p in densities):
        raise ValueError("densities must lie on one device")
    manifolds.require_euclidean(addop, diffop, get_mu, get_lambda,
                                densities[0].ndim)
    dtype = dtype or densities[0].dtype
    plan = _get_plan(densities, n_out, dtype, device)
    dn, d, n_levels = plan.ndens, plan.ndim, plan.n_levels
    mask = _mask_tensor(partial_dim_mask, dn, d, device)
    if (rand_u is None) != (rand_n is None):
        raise ValueError(
            "replay mode needs BOTH streams: pass rand_u (uniforms) and "
            "rand_n (normals) together (reference src/MSGibbs01.jl:661-662)")
    bu, bn = _stream_sizes(dn, d, n_levels, n_iter)
    if rand_u is None:
        u, nrm = _keyed_streams(key, n_out, bu, bn, dtype, device)
    else:
        # streams may be over-allocated (the reference sizes randU at
        # Np*Ndens*(Niter+2)*Nlevels, :661); the first n_out*bu / n_out*bn
        # draws are consumed, contiguously
        u = torch.as_tensor(np.asarray(rand_u, dtype=np.float64).ravel()
                            [:n_out * bu].reshape(n_out, bu),
                            dtype=dtype, device=device)
        nrm = torch.as_tensor(np.asarray(rand_n, dtype=np.float64).ravel()
                              [:n_out * bn].reshape(n_out, bn),
                              dtype=dtype, device=device)
    pts, idx, labels = _gibbs_all_chains(u, nrm, plan, mask, n_iter,
                                         add_entropy)
    out = (pts.T, idx.T)
    if record_labels:
        out = out + (labels.permute(0, 2, 1),)
    return out


def product(densities: Sequence[KDE], add_entropy: bool = True,
            key=None) -> KDE:
    """The ``*`` operator: a Gibbs product with Niter=5 sized at the mean
    component count, then an LOOCV refit of the samples on their device
    (reference src/MSGibbs01.jl:707-736)."""
    densities = list(densities)
    if len(densities) == 1 and not add_entropy:
        # the reference's #70 short-circuit (src/MSGibbs01.jl:712-716)
        return kde(densities[0].get_points())
    n_out = int(round(float(np.mean([p.npts for p in densities]))))
    pts, _ = prod_appx_ms_gibbs(n_out, densities, n_iter=5,
                                add_entropy=add_entropy, key=key)
    return kde(pts)


class ProductSampler:
    """Reusable sampler for repeated products over the same densities: the
    plan is built once and each :meth:`sample` draws a fresh product (the
    serving path of nonparametric belief propagation).

    >>> sampler = ProductSampler([p, q], n_out=1000, n_iter=5)
    >>> pts, labels = sampler.sample(torch.Generator().manual_seed(0))
    """

    def __init__(self, densities: Sequence[KDE], n_out: int,
                 n_iter: int = 5, add_entropy: bool = True,
                 partial_dim_mask=None, dtype=None):
        self.densities = list(densities)
        self.device = self.densities[0].device
        if any(p.device != self.device for p in self.densities):
            raise ValueError("densities must lie on one device")
        self.dtype = dtype or self.densities[0].dtype
        self.n_out = n_out
        self.n_iter = n_iter
        self.add_entropy = add_entropy
        self.plan = _get_plan(self.densities, n_out, self.dtype, self.device)
        self.mask = _mask_tensor(partial_dim_mask, self.plan.ndens,
                                 self.plan.ndim, self.device)
        self.bu, self.bn = _stream_sizes(self.plan.ndens, self.plan.ndim,
                                         self.plan.n_levels, n_iter)

    def sample(self, key=None, select: str = "auto"):
        """Returns ``(points [d, n_out], labels [ndens, n_out])``."""
        _resolve_select(select)
        u, nrm = _keyed_streams(key, self.n_out, self.bu, self.bn,
                                self.dtype, self.device)
        pts, idx, _ = _gibbs_all_chains(u, nrm, self.plan, self.mask,
                                        self.n_iter, self.add_entropy)
        return pts.T, idx.T
