"""Approximate products of KDEs by multiscale Gibbs sampling (ports
``kde_tpu/ops/gibbs.py:59-204, 237-414, 498-818, 883-1189``; algorithm:
Ihler, Sudderth, Freeman & Willsky, "Efficient multiscale sampling from
products of Gaussian mixtures", NIPS 2003; reference src/MSGibbs01.jl).

Every output sample is an independent chain.  All chains walk the same
level schedule: dense padded per-level arrays of node (mean, variance,
weight), built on the host from the densities' ball trees
(:class:`_ProductPlan`) or on their device (ops/device_plan.py).  At each
level a chain (1) draws X from the product of its current selections,
(2) re-selects one label per density conditioned on X, and (3) runs
``n_iter`` sweeps of leave-one-out Gibbs over the densities; a final draw
ends the chain.  :func:`_run_chain` runs a block of chains of ``B``
same-shaped density sets at once, written out as the leading tensor
dimensions ``[B, C, ...]``: a single product is ``B = 1``, and
:class:`BatchedProductSampler` / :func:`product_batched` (the serving path
of belief propagation) run ``B`` products as one chain batch.

All randomness is drawn up front per chain: ``bu = dn*(1 + L*(1+n_iter))``
uniforms and ``bn = d*(L+1)`` normals, in the reference's consumption order
(its ``randU``/``randN`` buffers, src/MSGibbs01.jl:661-662).  Injected
streams therefore replay a serial trace exactly ("replay mode").  Keyed
draws come from an explicit ``torch.Generator`` per set, and pick labels by
the flat inverse CDF, block by block, or by Gumbel-max
(:func:`resolve_select`).  Gumbel-max takes the normals and then a seed of
two 32-bit words from the set's generator, and no uniforms: its noise is a
counter draw (Threefry-2x32, utils/random.py), a pure function of the
seed, the chain's global index, the selection id and the candidate, as
the JAX package folds a stage id into each chain's key.  So a chain's
gumbel draw does not depend on the chain blocks, the layout or the launch.

Numerical guards kept from the reference: per-dimension NaN suppression
(:302-304), the degenerate fallback to a uniform draw when the candidate
likelihood total is below 1e-99 (:311-315, tested in log space), and
partial-dimension information zeroing (:189-209).  Manifold hooks
(manifolds.py) enter the information-form product, the candidate
differences and the point draw; every set of a batch shares one quadruple.
"""

from __future__ import annotations

import math
import weakref
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config, manifolds
from ..density import KDE, kde
from ..utils.random import (counter_seed, counter_uniform, make_generator,
                            split)
from ..utils.spans import span
from . import gibbs_chain as _gc
from . import gibbs_select as _gs
from .balltree import n_levels as _n_levels
from .balltree import pack_levels
from .device_plan import DeviceProductPlan, batched_device_plans
from .loocv import _slices_on, ksize_rows, select_loo_impl

# Budget for the live [chains, level width] temporaries of one set's chain
# block.  Chains are i.i.d. given their stream rows, so blocking is layout
# only.
CHAIN_BLOCK_BYTES: int = 2 << 30

# about this many [chains, width] temporaries are alive at once on the eager
# twin route; the kernel routes keep none (:func:`_live_temps`)
_LIVE_TEMPS = 8

# log(1e-99): the reference's degenerate-likelihood threshold
# (src/MSGibbs01.jl:311, `cmo.pT < 1e-99`)
_LOG_DEAD = float(np.log(1e-99))


# ---------------------------------------------------------------------------
# host-side precompute
# ---------------------------------------------------------------------------

class _ProductPlan:
    """Dense, padded per-level arrays for a set of densities, built on the
    host in NumPy from the densities' ball trees and moved to ``device``:
    ``t_mean``/``t_bw`` ``[dn, 2N, d]``, ``lvl_mean``/``lvl_bw``
    ``[dn, T, d]``, ``lvl_logw``/``lvl_perm`` ``[dn, T]``; level ``l`` is
    the node slice ``offsets[l-1]``; ``lvl_uniform [dn, L, d]``, which
    levels have one bandwidth a dim (``gibbs_chain.level_uniform``, taken on
    the host)."""

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
        self.offsets, nodes, valid = pack_levels(
            [t.level_lists(self.n_levels) for t in trees], self.n_levels)
        idx_j = np.arange(dn)[:, None]
        lvl_logw = (np.log(np.maximum(t_wt[idx_j, nodes], 1e-300))
                    + np.where(valid, 0.0, -np.inf))

        dev = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
        self.t_mean = dev(t_mean)
        self.t_bw = dev(t_bw)
        self.lvl_mean = dev(t_mean[idx_j, nodes])
        self.lvl_bw = dev(t_bw[idx_j, nodes])
        self.lvl_logw = dev(lvl_logw)
        self.lvl_perm = torch.as_tensor(t_perm[idx_j, nodes], device=device)
        self.lvl_uniform = _gc.level_uniform(
            torch.as_tensor(t_bw[idx_j, nodes], dtype=dtype),
            self.offsets).to(device)


_PLAN_TENSORS = ("t_mean", "t_bw", "lvl_mean", "lvl_bw", "lvl_logw",
                 "lvl_perm")


class _SetPlans(NamedTuple):
    """The plans of ``B`` same-shaped density sets with a leading set axis
    (the plan arrays of ``kde_tpu/ops/gibbs.py:1076-1091``):
    ``t_mean``/``t_bw`` ``[B, dn, 2N, d]``, ``lvl_mean``/``lvl_bw``
    ``[B, dn, T, d]``, ``lvl_logw``/``lvl_perm`` ``[B, dn, T]``, and
    ``lvl_uniform [B, dn, L, d]`` (``gibbs_chain.level_uniform``)."""
    t_mean: torch.Tensor
    t_bw: torch.Tensor
    lvl_mean: torch.Tensor
    lvl_bw: torch.Tensor
    lvl_logw: torch.Tensor
    lvl_perm: torch.Tensor
    offsets: List[Tuple[int, int]]
    n_levels: int
    lvl_uniform: torch.Tensor

    def level(self, l: int):
        """Level ``l`` (1-based): mean/bw ``[B, dn, w, d]``, logw and perm
        ``[B, dn, w]``."""
        o, w = self.offsets[l - 1]
        return (self.lvl_mean[:, :, o:o + w], self.lvl_bw[:, :, o:o + w],
                self.lvl_logw[:, :, o:o + w], self.lvl_perm[:, :, o:o + w])

    def level_uniform(self, l: int) -> torch.Tensor:
        """Level ``l``'s uniform flags ``[B, dn, d]`` (contiguous)."""
        return self.lvl_uniform[:, :, l - 1].contiguous()


def _stack_plans(plans) -> _SetPlans:
    """One plan gets a set axis of 1 (views); several are stacked.  Sets of
    the same per-position component counts have the same level offsets."""
    p0 = plans[0]
    assert all(p.offsets == p0.offsets for p in plans), "offsets differ"
    stack = (lambda xs: xs[0][None]) if len(plans) == 1 else torch.stack
    return _SetPlans(*(stack([getattr(p, f) for p in plans])
                       for f in _PLAN_TENSORS),
                     list(p0.offsets), p0.n_levels,
                     stack([p.lvl_uniform for p in plans]))


def _resolve_plan_impl(densities: Sequence[KDE], plan: str,
                       replay: bool) -> str:
    """``auto``: the device builder when any density is device-resident (no
    host arrays and no host tree, e.g. the output of an earlier product),
    since the host builder would copy it to the host; the host builder
    otherwise.  Replay mode always takes the host plan: the device
    hierarchy is statistically equivalent but not trace-identical in d > 1
    (ops/device_plan.py)."""
    if plan == "auto":
        if replay:
            return "host"
        dev = any(p._host_points is None and p._tree is None
                  for p in densities)
        return "device" if dev else "host"
    if plan not in ("host", "device"):
        raise ValueError(f"plan must be auto|host|device, got {plan!r}")
    if replay and plan == "device":
        raise ValueError(
            "replay mode (rand_u=) requires the host plan: the device-built "
            "hierarchy is statistically equivalent but not trace-identical "
            "in d>1, so replayed labels would silently diverge from the "
            "injected reference trace (ops/device_plan.py parity contract)")
    return plan


# Plan cache keyed by the identity of the densities and the level, dtype,
# device and builder configuration; an entry is evicted when any of its
# densities is collected.
_plan_cache: dict = {}


def _get_plan(densities: Sequence[KDE], n_out: int, dtype, device,
              impl: str = "host"):
    key = (tuple(id(p) for p in densities), tuple(p.npts for p in densities),
           _n_levels(n_out, [p.npts for p in densities]), str(dtype),
           str(device), impl)
    hit = _plan_cache.get(key)
    with span("plan", cache="miss" if hit is None else "hit", impl=impl):
        if hit is not None:
            return hit
        if impl == "device":
            plan = DeviceProductPlan(densities, n_out, dtype)
        else:
            plan = _ProductPlan(densities, n_out, dtype, device)
    _plan_cache[key] = plan

    def _evict(key=key):
        _plan_cache.pop(key, None)
    for p in densities:
        weakref.finalize(p, _evict)
    return plan


# ---------------------------------------------------------------------------
# manifold hooks
# ---------------------------------------------------------------------------

# (addop, diffop, get_mu, get_lambda), all Euclidean
_NO_HOOKS = (None, None, None, None)


def normalize_hooks(addop, diffop, get_mu, get_lambda, d):
    """Broadcast the hook tuples to ``d`` dims and canonicalize
    (``kde_tpu/ops/gibbs.py:207-230``): all-Euclidean tuples collapse to
    ``None`` (the fast paths), and a custom ``get_lambda`` with a default
    ``get_mu`` (or the reverse) fills in the default explicitly, so the
    generic information-form path runs instead of ignoring the custom
    hook."""
    addop_t = manifolds.broadcast_ops(addop, d)
    diffop_t = manifolds.broadcast_ops(diffop, d)
    get_mu_t = manifolds.broadcast_ops(get_mu, d)
    get_lambda_t = manifolds.broadcast_ops(get_lambda, d)
    if manifolds.is_euclidean(addop_t, manifolds.euclid_add):
        addop_t = None
    if manifolds.is_euclidean(diffop_t, manifolds.euclid_diff):
        diffop_t = None
    if manifolds.is_euclidean(get_lambda_t, manifolds.euclid_lambda) and \
       manifolds.is_euclidean(get_mu_t, manifolds.euclid_mu):
        get_mu_t = get_lambda_t = None
    elif get_mu_t is None:
        get_mu_t = (manifolds.euclid_mu,) * d
    elif get_lambda_t is None:
        get_lambda_t = (manifolds.euclid_lambda,) * d
    return addop_t, diffop_t, get_mu_t, get_lambda_t


def _density_hooks(densities: Sequence[KDE]):
    """The hooks the densities carry, for the product engine
    (``kde_tpu/ops/gibbs.py:821-880``; reference src/MSGibbs01.jl:672-675).

    The hooks describe the product space, so if any density carries a
    non-Euclidean hook every density must carry the identical tuple; and
    per dimension the quadruple must be all Euclidean or all not (a
    wrapped addop/diffop with a Euclidean product mean would put mass on
    the wrong side of the wrap).  Either mismatch raises ``ValueError``.
    Returns ``(addop, diffop, get_mu, get_lambda)``, ``None`` for
    all-Euclidean."""
    out = []
    for attr, default in manifolds.HOOK_DEFAULTS:
        carried = [(i, getattr(p, attr, None))
                   for i, p in enumerate(densities)]
        non_euclid = [(i, ops) for i, ops in carried
                      if not manifolds.is_euclidean(ops, default)]
        if not non_euclid:
            out.append(None)
            continue
        first = non_euclid[0][1]
        for i, ops in carried:
            if ops is None or tuple(ops) != tuple(first):
                raise ValueError(
                    f"density {non_euclid[0][0]} carries a non-Euclidean "
                    f"{attr} but density {i} does not match; products "
                    "require every density to carry identical manifold "
                    "hooks (the hooks describe the shared product space, "
                    "reference src/MSGibbs01.jl:672-675)")
        out.append(first)
    d = densities[0].ndim
    specs = manifolds.HOOK_DEFAULTS
    bcast = [manifolds.broadcast_ops(h, d) if h is not None else
             (default,) * d for h, (_, default) in zip(out, specs)]
    for k in range(d):
        wrapped = {attr: ops[k] is not default
                   for ops, (attr, default) in zip(bcast, specs)}
        if any(wrapped.values()) and not all(wrapped.values()):
            have = [a for a, w in wrapped.items() if w]
            missing = [a for a, w in wrapped.items() if not w]
            raise ValueError(
                f"dimension {k} carries non-Euclidean {have} but Euclidean "
                f"{missing}: the product engine needs the full "
                "addop/diffop/get_mu/get_lambda quadruple per manifold "
                "dimension (a Euclidean product mean on a wrapped "
                "dimension places mass on the wrong chart); attach all "
                "four, or call prod_appx_ms_gibbs with explicit hooks")
    return tuple(out)


# ---------------------------------------------------------------------------
# chain-batched primitives; B = density sets, C = chains per set in the block
# ---------------------------------------------------------------------------

def _gauss_product(mu_sel, var_sel, mask, skip: int, get_mu=None,
                   get_lambda=None):
    """Information-form product of the selected kernels over densities
    (reference gaussianProductMeanCov!, src/MSGibbs01.jl:176-216).

    ``mu_sel``/``var_sel`` ``[B, C, dn, d]`` (zeroed at inactive dims),
    ``mask [B, dn, d]``, ``skip``: density left out, or -1.  With hooks,
    dim ``k`` combines with ``get_lambda[k]``/``get_mu[k]`` over the
    density axis of ``[B, C, dn]`` slices (manifolds.py).  Returns
    ``(mu, cov)``, ``[B, C, d]`` each, zero where no density contributes."""
    dn = mask.shape[1]
    keep = torch.arange(dn, device=mask.device)[:, None] != skip
    contrib = (mask & keep)[:, None]                          # [B, 1, dn, d]
    pos = var_sel > 0
    lam = torch.where(contrib & pos,
                      1.0 / torch.where(pos, var_sel, torch.ones_like(var_sel)),
                      torch.zeros_like(var_sel))
    has = contrib.any(dim=2)                                  # [B, 1, d]
    if get_lambda is None:                                    # Euclidean
        lam_tot = lam.sum(dim=2)                              # [B, C, d]
        cov = torch.where(has, 1.0 / torch.where(has, lam_tot,
                                                 torch.ones_like(lam_tot)),
                          torch.zeros_like(lam_tot))
        return cov * (lam * mu_sel).sum(dim=2), cov
    covs, mus = [], []
    for k in range(mu_sel.shape[3]):
        lt = get_lambda[k](lam[..., k], axis=-1)              # [B, C]
        h = has[..., k]                                       # [B, 1]
        c = torch.where(h, 1.0 / torch.where(h, lt, torch.ones_like(lt)),
                        torch.zeros_like(lt))
        covs.append(c)
        mus.append(torch.where(h, get_mu[k](mu_sel[..., k], lam[..., k], c,
                                            axis=-1), torch.zeros_like(c)))
    return torch.stack(mus, dim=-1), torch.stack(covs, dim=-1)


def _kernel_logits_raw(lvl_mean_j, lvl_bw_j, lvl_logw_j, mu, cov, active,
                       diffop=None):
    """Candidate log-likelihoods ``[B, C, w]`` of one density's level nodes
    (``lvl_mean_j``/``lvl_bw_j`` ``[B, w, d]``, ``lvl_logw_j [B, w]``)
    against a Gaussian of mean ``mu [B, C, d]`` and covariance ``bw + cov``
    (``cov`` ``[B, C, d]`` or None), without the degenerate fallback
    (reference makeFasterSampleIndex!, src/MSGibbs01.jl:250-328).  A dim
    gives 0 where it is NaN (:302-304) or inactive for its set (the
    partial-dim skip :281-285).  ``active = (tensor [B, d], its NumPy
    copy)``: a dim inactive in every set is skipped and one active in
    every set needs no mask, so only mixed sets pay for the masking.
    ``diffop``: per-dim manifold differences, or None."""
    active_dim, active_host = active
    acc = None
    for k in range(lvl_mean_j.shape[2]):
        if not active_host[:, k].any():
            continue
        c = lvl_bw_j[:, None, :, k]
        if cov is not None:
            c = c + cov[:, :, k:k + 1]
        if diffop is None:
            delta = lvl_mean_j[:, None, :, k] - mu[:, :, k:k + 1]
        else:
            delta = diffop[k](lvl_mean_j[:, None, :, k], mu[:, :, k:k + 1])
        per_dim = delta * delta / c + torch.log(c)
        per_dim = per_dim.nan_to_num(nan=0.0, posinf=math.inf,
                                     neginf=-math.inf)
        if not active_host[:, k].all():
            per_dim = torch.where(active_dim[:, None, None, k], per_dim, 0.0)
        acc = per_dim if acc is None else acc + per_dim
    if acc is None:
        acc = torch.zeros(mu.shape[:2] + lvl_logw_j.shape[-1:],
                          dtype=mu.dtype, device=mu.device)
    logits = lvl_logw_j[:, None, :] - 0.5 * acc
    return logits.nan_to_num(nan=-math.inf, posinf=math.inf,
                             neginf=-math.inf)


def _dead_predicate(logits):
    """``[B, C]``: True iff ``sum(exp(logits)) < 1e-99``, the log-space form
    of the reference's linear-f64 degenerate test (src/MSGibbs01.jl:311).
    The safe shift makes an all -inf row dead."""
    m = logits.max(dim=-1).values
    ms = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    lse = ms + torch.log(torch.exp(logits - ms[..., None]).sum(dim=-1))
    return lse < _LOG_DEAD


def _apply_dead_fallback(logits, lvl_logw_j, dead):
    """Where ``dead``, draw uniformly over the real candidate nodes
    (reference src/MSGibbs01.jl:311-315): 0 for real candidates, -inf for
    padding."""
    fallback = torch.where(torch.isneginf(lvl_logw_j),
                           torch.full_like(lvl_logw_j, -math.inf),
                           torch.zeros_like(lvl_logw_j))
    return torch.where(dead[..., None], fallback[:, None, :], logits)


def _select_label(u, logits):
    """Inverse-CDF draw: labels ``[...]`` from uniforms ``u [...]`` and
    ``logits [..., w]``, the count of CDF entries below ``u``, i.e. the
    first index whose CDF reaches ``u`` (reference selectLabelOnLevel,
    src/MSGibbs01.jl:330-351, accepting on ``u <= cdf``).  The
    probabilities are normalized *before* the cumulative sum, as in the
    reference and the serial oracle, so replayed labels flip only where
    they would there.  The CDF is accumulated in float64 (a no-op for
    float64 chains): on CUDA the summation order of ``torch.cumsum``
    depends on the whole tensor's shape, and in float32 that moves ulp-wide
    CDF ties between a set drawn in a batch and the same set drawn
    alone."""
    e = torch.exp(logits - logits.max(dim=-1, keepdim=True).values
                  ).to(torch.float64)
    cdf = torch.cumsum(e / e.sum(dim=-1, keepdim=True), dim=-1)
    z = (cdf < u[..., None]).sum(dim=-1)
    return z.clamp(0, logits.shape[-1] - 1)


def _blocked_block_size(w: int) -> int:
    """Block size for :func:`_select_label_blocked`: ~sqrt(width), a power
    of two in [32, 512] (``kde_tpu/ops/gibbs.py:357-362``)."""
    return 1 << max(5, min(9, int(round(math.log2(max(1.0,
                                                      math.sqrt(w)))))))


def _select_label_blocked(u, logits, block: int):
    """Two-level inverse-CDF draw for the keyed path: the draw of
    :func:`_select_label` for the same single uniform ``u`` (one stream
    slot), with no full-width prefix sum.  The width splits as
    ``w = nb x block``: one full pass gives the block sums, a scan over the
    ``nb`` sums picks the block, and a scan inside that block resolves the
    index.  In exact arithmetic this is the flat index; ulp-wide CDF ties
    may resolve differently, which is why replay mode keeps the flat form.
    The degenerate fallback composes unchanged (0/-inf logits give equal
    masses per real candidate).  Sums and scans run in float64, as in
    :func:`_select_label`."""
    w = logits.shape[-1]
    nb = -(-w // block)
    e = torch.exp(logits - logits.max(dim=-1, keepdim=True).values
                  ).to(torch.float64)
    e2 = torch.nn.functional.pad(e, (0, nb * block - w)).reshape(
        e.shape[:-1] + (nb, block))
    s = e2.sum(dim=-1)                                        # [..., nb]
    c = torch.cumsum(s, dim=-1)
    t = u * c[..., -1]
    b = (c < t[..., None]).sum(dim=-1).clamp(0, nb - 1)
    at = lambda x: x.gather(-1, b[..., None])[..., 0]
    r = t - (at(c) - at(s))                   # mass entering block b
    eb = e2.gather(-2, b[..., None, None].expand(b.shape + (1, block)))
    zin = (torch.cumsum(eb[..., 0, :], dim=-1) < r[..., None]).sum(dim=-1)
    return (b * block + zin.clamp(0, block - 1)).clamp(0, w - 1)


def _select_label_gumbel(seeds, logits, chain0: int = 0, sel: int = 0):
    """Gumbel-max draw for the keyed path: ``argmax(logits + G)`` with
    ``G = -log(-log U)`` (``logits [B, C, w]``), ``U`` the counter draw of
    set ``b``'s seed ``seeds[b]``, chains ``chain0 ..`` and selection
    ``sel`` (:func:`_gumbel_noise`).  It samples softmax(logits), the
    distribution of the inverse-CDF draw.  ``U`` is clamped away from 0 and
    1 so ``G`` stays finite; dead rows (0 for real candidates, -inf for
    padding) then give a uniform draw that never lands on padding."""
    _, c, w = logits.shape
    chains = torch.arange(chain0, chain0 + c, device=logits.device)
    u = _gumbel_noise(seeds, chains, (sel,), w, logits.dtype)[:, :, 0]
    # the first index wins ties
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _gumbel_noise(seeds, chains, sels: Sequence[int], w: int, dtype):
    """The uniforms of one gumbel stage: ``[B, C, |sels|, w]`` for the
    global chain indices ``chains [C]`` and the selection ids ``sels`` of
    ``B`` sets seeded by ``seeds [B, 2]``: ``utils/random.py::
    counter_uniform``, the draw the kernels make in registers (a pure
    function of seed, chain, selection and candidate, so it does not
    depend on the chain blocks or the launch)."""
    return counter_uniform(seeds, chains, torch.as_tensor(
        sels, dtype=torch.int64, device=seeds.device), w, dtype)


def _sample_point(mu_sel, var_sel, mask, normals, jitter: bool,
                  hooks=_NO_HOOKS):
    """Draw ``[B, C, d]`` from the product of the current selections
    (reference samplePoint!, src/MSGibbs01.jl:440-463), stepping with the
    per-dim ``addop`` when the hooks carry one."""
    addop, _, get_mu, get_lambda = hooks
    mu, cov = _gauss_product(mu_sel, var_sel, mask, -1, get_mu, get_lambda)
    if not jitter:
        return mu
    step = torch.sqrt(cov) * normals
    if addop is None:
        return mu + step
    return torch.stack([addop[k](mu[..., k], step[..., k])
                        for k in range(mu.shape[-1])], dim=-1)


class _Stage(NamedTuple):
    """The raw inputs of one selection step of :func:`_run_chain`: the
    densities ``js`` (a contiguous range: all of them in the conditioning
    step, one in a sweep), the Gaussian each candidate is scored against
    (mean ``mu [B, C, d]``, added covariance ``cov [B, C, d]`` or None),
    the uniforms ``u [B, C, |js|]`` (None for gumbel), the active dims
    ``active [B, dn, d]`` with their host copy, the per-dim ``diffop``
    (None: Euclidean) and the selection id of ``js[0]``, ``sel`` (density
    ``js[jj]``'s is ``sel + jj``): the column of the uniform stream that
    cdf reads for it, which keys gumbel's counter noise; ``uniform [B, dn,
    d]`` flags the dims where the level's bandwidth is the same for every
    candidate (the plan's ``level_uniform``; None: not known)."""
    js: Tuple[int, ...]
    mu: torch.Tensor
    cov: Optional[torch.Tensor]
    u: Optional[torch.Tensor]
    active: torch.Tensor
    active_host: np.ndarray
    diffop: Optional[tuple]
    sel: int = 0
    uniform: Optional[torch.Tensor] = None

    def logits(self, j: int, lvl):
        """Density ``j``'s raw candidate logits ``[B, C, w]`` at the level
        ``lvl``, in eager torch ops (:func:`_kernel_logits_raw`)."""
        return _kernel_logits_raw(lvl[0][:, j], lvl[1][:, j], lvl[2][:, j],
                                  self.mu, self.cov,
                                  (self.active[:, j], self.active_host[:, j]),
                                  self.diffop)


def _select_eager(stage: _Stage, lvl, draw):
    """The selection step in eager torch ops, density by density: the raw
    logits, the degenerate fallback, ``draw(jj, logits)``'s labels ``[B,
    C]`` for the ``jj``-th density of ``stage.js``, and the gather of the
    winner's mean, variance and original label from ``lvl``.  Returns
    ``(mean, var [B, C, |js|, d], label [B, C, |js|])``."""
    lvl_mean, lvl_bw, lvl_logw, lvl_perm = lvl
    sets = torch.arange(lvl_mean.shape[0], device=lvl_mean.device)[:, None]
    outs = []
    for jj, j in enumerate(stage.js):
        logits = stage.logits(j, lvl)
        logits = _apply_dead_fallback(logits, lvl_logw[:, j],
                                      _dead_predicate(logits))
        z = draw(jj, logits)
        outs.append((lvl_mean[sets, j, z], lvl_bw[sets, j, z],
                     lvl_perm[sets, j, z]))
    return tuple(torch.stack(parts, dim=2) for parts in zip(*outs))


def _local_choose(select: str = "cdf", seeds=None, chain0: int = 0):
    """The single-device selection step of :func:`_run_chain` for chains
    ``chain0 ..`` of the sets seeded by ``seeds [B, 2]`` (gumbel):
    ``choose(stage, lvl)`` gives each density of ``stage.js`` its winner's
    ``(mean [B, C, d], var [B, C, d], label [B, C])``.  ``cdf`` and
    ``gumbel`` go through :func:`gibbs_select.gibbs_select` (the kernel on
    the card, which draws gumbel's counter noise itself); ``blocked`` and
    a user's own ``diffop``, which no kernel runs, take the eager twin by
    design (counted in ``gibbs_select.TWIN_STAGES``), gumbel with the
    noise of :func:`_gumbel_noise`."""
    def choose(stage: _Stage, lvl):
        codes = _gs.diff_codes(stage.diffop, stage.mu.shape[2])
        if select == "blocked" or codes is None:
            _gs.TWIN_STAGES += 1

            def draw(jj, logits):
                w = logits.shape[-1]
                if select == "gumbel":
                    return _select_label_gumbel(seeds, logits, chain0,
                                                stage.sel + jj)
                if select == "blocked" and w > 128:   # narrow: the scan
                    return _select_label_blocked(stage.u[:, :, jj], logits,
                                                 _blocked_block_size(w))
                return _select_label(stage.u[:, :, jj], logits)
            mean, var, label = _select_eager(stage, lvl, draw)
        else:
            gumbel = select == "gumbel"
            mean, var, label = _gs.gibbs_select(
                *lvl, stage.js, stage.mu, stage.cov, stage.active, codes,
                u=None if gumbel else stage.u,
                seeds=seeds if gumbel else None, chain0=chain0,
                sel0=stage.sel, uniform=None if gumbel else stage.uniform)
        return [(mean[:, :, i], var[:, :, i], label[:, :, i])
                for i in range(len(stage.js))]
    return choose


def _run_chain(u, nrm, plans: _SetPlans, mask, n_iter: int,
               add_entropy: bool, select: str = "cdf", seeds=None,
               hooks=_NO_HOOKS, choose=None, chain0: int = 0):
    """A block of chains of ``B`` density sets.  ``u [B, C, bu]`` and
    ``nrm [B, C, bn]`` are their streams in the reference's consumption
    order:

      uniforms: [dn init] ++ per level ([dn cond] ++ [n_iter*dn gibbs])
      normals:  [(L+1) * d]

    ``mask [B, dn, d]``.  ``select``: ``cdf``, ``blocked`` (on levels wider
    than 128) or ``gumbel``, which takes ``u = None`` and draws its noise
    by counter from the sets' seeds ``seeds [B, 2]``, the chain's global
    index (the block's first chain is ``chain0``) and the selection id
    (the column cdf reads in ``u``).  ``hooks``: the normalized manifold
    quadruple
    (:func:`normalize_hooks`).  ``choose(stage, lvl)`` replaces the
    selection (default :func:`_local_choose`): it gives each density of
    ``stage.js`` its winner's ``(mean [B, C, d], var [B, C, d], label [B,
    C])`` from the stage's raw inputs (:class:`_Stage`) and
    ``plans.level(l)``; the kernel-sharded engine passes one that selects
    across shards.
    Returns ``points [B, C, d]``, final labels ``[B, C, dn]`` and per-level
    labels ``[B, C, L, dn]`` (0-based original point indices).  The
    reference's ``levelDown!`` label remap (:512-513) is left out: the
    conditioning re-selection overwrites it before any read."""
    b, c = nrm.shape[:2]
    dn, d, L = mask.shape[1], mask.shape[2], plans.n_levels
    _, diffop, get_mu, get_lambda = hooks
    choose = choose or _local_choose(select, seeds, chain0)
    zero = torch.zeros((), dtype=nrm.dtype, device=nrm.device)
    # dims carried by at least one OTHER density (the LOO dimmask,
    # reference src/MSGibbs01.jl:270-275)
    union_other = torch.stack([
        torch.cat([mask[:, :j], mask[:, j + 1:]], dim=1).any(dim=1)
        for j in range(dn)], dim=1)
    act_all = mask & union_other                              # [B, dn, d]
    act_host = act_all.cpu().numpy()
    stage = lambda js, mu, cov, us, sel: _Stage(tuple(js), mu, cov, us,
                                                act_all, act_host, diffop,
                                                sel, uni)
    if u is not None:
        per_level = u[:, :, dn:].reshape(b, c, L, (1 + n_iter) * dn)
        u_cond = per_level[..., :dn]
        u_gibbs = per_level[..., dn:].reshape(b, c, L, n_iter, dn)
    normals = nrm.reshape(b, c, L + 1, d)

    # initial selection: every tree's root (reference src/MSGibbs01.jl:89-107)
    root = lambda t: torch.where(mask, t[:, :, 0], zero)[:, None]
    mu_sel = root(plans.t_mean).expand(b, c, dn, d).contiguous()
    var_sel = root(plans.t_bw).expand(b, c, dn, d).contiguous()
    perms = torch.zeros((b, c, dn), dtype=torch.int64, device=nrm.device)
    labels = []

    def pick(j, sel):
        mean, var, perm = sel
        m = mask[:, None, j]
        mu_sel[:, :, j] = torch.where(m, mean, zero)
        var_sel[:, :, j] = torch.where(m, var, zero)
        perms[:, :, j] = perm

    for l in range(1, L + 1):
        lvl, uni = plans.level(l), plans.level_uniform(l)
        sel = dn + (l - 1) * (1 + n_iter) * dn      # u's column of the stage
        # (1) draw X from the product of the current selections (:594)
        x = _sample_point(mu_sel, var_sel, mask, normals[:, :, l - 1], True,
                          hooks)
        # (2) re-select every density's label conditioned on X (:600)
        sels = choose(stage(range(dn), x, None,
                            None if u is None else u_cond[:, :, l - 1], sel),
                      lvl)
        for j in range(dn):
            pick(j, sels[j])
        # (3) n_iter sweeps of sequential LOO Gibbs over densities (:604-608)
        for t in range(n_iter):
            for j in range(dn):
                mu, cov = _gauss_product(mu_sel, var_sel, mask, j, get_mu,
                                         get_lambda)
                us = None if u is None else u_gibbs[:, :, l - 1, t, j:j + 1]
                pick(j, choose(stage([j], mu, cov, us,
                                     sel + (1 + t) * dn + j), lvl)[0])
        labels.append(perms.clone())

    # final draw (:612-625)
    x = _sample_point(mu_sel, var_sel, mask, normals[:, :, L], add_entropy,
                      hooks)
    return x, labels[-1], torch.stack(labels, dim=2)


def _route(select: str, hooks, device, dn: int, d: int) -> str:
    """Where the local engine's chains run, fixed before any launch, from
    the selection, the normalized hook quadruple (None: Euclidean), the
    device and the densities and dims: ``chain`` on the card for ``cdf``
    and ``gumbel`` with Euclidean or circular hooks (one ``gibbs_chain``
    launch for every chain); ``kernel`` on the card for Euclidean or
    circular differences that the chain kernel does not take (a lone
    circular ``diffop``, more than ``MAX_DENS`` densities or ``MAX_DIM``
    dims: one ``gibbs_select`` launch a selection step); ``twin`` (eager
    torch ops) otherwise."""
    hooks = hooks or _NO_HOOKS
    if torch.device(device).type != "cuda" or select not in ("cdf", "gumbel"):
        return "twin"
    if (dn <= _gc.MAX_DENS and d <= _gc.MAX_DIM
            and _gc.hook_codes(hooks, d) is not None):
        return "chain"
    if _gs.diff_codes(hooks[1], d) is not None:
        return "kernel"
    return "twin"


def _live_temps(route: str) -> int:
    """The ``[chains, level width]`` temporaries a chain block keeps alive
    on ``route``: about ``_LIVE_TEMPS`` on the eager twin, none on the
    kernels (gumbel's noise is drawn inside them; the kernel-sharded
    engine's ``sharded`` route recomputes its logits in each phase)."""
    return _LIVE_TEMPS if route == "twin" else 0


def _chain_block(n_out: int, plan, itemsize: int,
                 live: int = _LIVE_TEMPS) -> int:
    """Chains per block and per set, so one set's ``live`` temporaries stay
    within ``CHAIN_BLOCK_BYTES``.  A batch of ``B`` sets runs ``B`` such
    blocks at once.  Blocking is layout only: chains are numbered globally,
    and gumbel's noise is a function of the chain's index, not its
    block."""
    return _chains_per_block(n_out, max(w for _, w in plan.offsets),
                             itemsize, live)


def _chains_per_block(n_out: int, width: int, itemsize: int,
                      live: int = _LIVE_TEMPS) -> int:
    """:func:`_chain_block` for a plan whose widest level has ``width``
    candidates; with no live temporary every chain is one block."""
    per_chain = live * width * itemsize
    if per_chain == 0:
        return max(1, n_out)
    return max(1, min(n_out, CHAIN_BLOCK_BYTES // per_chain))


def _gibbs_all_chains(u, nrm, plans: _SetPlans, mask, n_iter: int,
                      add_entropy: bool, select: str = "cdf", seeds=None,
                      hooks=_NO_HOOKS, choose=None, route=None):
    """All chains of ``B`` sets (``nrm [B, n_out, bn]``; gumbel: ``u`` None
    and the sets' counter seeds ``seeds [B, 2]``): on the ``chain`` route
    one ``gibbs_chain`` launch; otherwise in blocks of
    :func:`_chain_block` chains per set, sized for the selection's route
    (the block count depends only on the plan's widths, ``n_out`` and the
    route, which every rank of a mesh shares).  A caller's ``choose``
    comes with its ``route`` (default ``twin``)."""
    n_out = nrm.shape[1]
    dn, d = mask.shape[1:]
    if choose is None:
        route = _route(select, hooks, nrm.device, dn, d)
    else:
        route = route or "twin"
    with span("chains", route=route, select=select, sets=nrm.shape[0],
              n_out=n_out) as attrs:
        if attrs is not None:
            attrs["widths"] = [w for _, w in plans.offsets]
        if route == "chain":
            return _gc.gibbs_chain(u, nrm, plans, mask, n_iter, add_entropy,
                                   _gc.hook_codes(hooks, d), select, seeds)
        block = _chain_block(n_out, plans, nrm.element_size(),
                             _live_temps(route))
        outs = [_run_chain(None if u is None else u[:, s:s + block],
                           nrm[:, s:s + block], plans, mask, n_iter,
                           add_entropy, select, seeds, hooks, choose,
                           chain0=s)
                for s in range(0, n_out, block)]
        return tuple(torch.cat(parts, dim=1) for parts in zip(*outs))


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def resolve_select(select: str, n_out: Optional[int] = None,
                   width: Optional[int] = None, batch: int = 1) -> str:
    """The keyed path's label selection (``kde_tpu/ops/gibbs.py:658-690``).

    ``auto`` reads ``config.GIBBS_SELECT`` at call time; its default
    ``size`` routes by problem size with the thresholds ``config.SELECT_*``
    (measured on the H100, PERF.md): ``blocked`` for very wide leaves with
    few chains and one set, ``gumbel`` for wide leaves, large
    chains x width work or many sets, flat ``cdf`` otherwise.  ``n_out``,
    ``width`` and ``batch`` are the chains, the padded leaf width and the
    number of sets; with unknown sizes ``size`` gives ``cdf``."""
    if select == "auto":
        select = config.GIBBS_SELECT
    if select == "size":
        if n_out is None or width is None:
            return "cdf"
        if (width >= config.SELECT_BLOCKED_WIDTH
                and n_out <= config.SELECT_BLOCKED_MAX_CHAINS
                and batch == 1):
            return "blocked"
        if (width >= config.SELECT_GUMBEL_WIDTH
                or batch >= config.SELECT_GUMBEL_BATCH
                or n_out * width >= config.SELECT_GUMBEL_WORK):
            return "gumbel"
        return "cdf"
    if select not in ("cdf", "blocked", "gumbel"):
        raise ValueError(
            f"select must be auto|size|cdf|blocked|gumbel, got {select!r}")
    return select


def _stream_sizes(dn: int, d: int, n_levels: int, n_iter: int):
    return dn * (1 + n_levels * (1 + n_iter)), d * (n_levels + 1)


def _keyed_streams(gen, n_out: int, bu: int, bn: int, dtype, device,
                   select: str):
    """Uniform ``[n_out, bu]`` and normal ``[n_out, bn]`` streams from
    ``gen`` (chain ``i`` consumes row ``i`` of each), and the seed of the
    counter draws (``utils/random.py::counter_seed``), drawn right after
    the normals: ``gumbel`` takes the normals and the seed, no uniforms;
    the other selections the two streams and no seed."""
    gumbel = select == "gumbel"
    u = (None if gumbel else
         torch.rand((n_out, bu), generator=gen, dtype=dtype, device=device))
    nrm = torch.randn((n_out, bn), generator=gen, dtype=dtype, device=device)
    return u, nrm, counter_seed(gen) if gumbel else None


def _gibbs_keyed(gens, plans: _SetPlans, mask, n_out: int, n_iter: int,
                 add_entropy: bool, dtype, select: str, hooks=_NO_HOOKS):
    """Keyed products of ``B = len(gens)`` sets: set ``b`` draws all its
    randomness from ``gens[b]``.  Returns ``points [B, d, n_out]``, labels
    ``[B, dn, n_out]`` and per-level labels ``[B, n_out, dn, L]``."""
    dn, d = mask.shape[1:]
    bu, bn = _stream_sizes(dn, d, plans.n_levels, n_iter)
    device = mask.device
    gumbel = select == "gumbel"
    with span("streams", sets=len(gens), select=select):
        streams = [_keyed_streams(g, n_out, bu, bn, dtype, device, select)
                   for g in gens]
        u = None if gumbel else torch.stack([s[0] for s in streams])
        nrm = torch.stack([s[1] for s in streams])
        seeds = torch.stack([s[2] for s in streams]) if gumbel else None
    pts, idx, labels = _gibbs_all_chains(u, nrm, plans, mask, n_iter,
                                         add_entropy, select, seeds, hooks)
    return pts.transpose(1, 2), idx.transpose(1, 2), labels.transpose(2, 3)


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
                       plan: str = "auto",
                       select: str = "auto"):
    """Draw samples from (an approximation of) the product of ``densities``
    (reference prodAppxMSGibbsS, src/MSGibbs01.jl:645-703).

    Args:
      npd0: a KDE whose ``npts`` is the number of samples, or an int.
      densities: the KDEs to multiply, all on one device.
      an_fcns/an_params: accepted for API compatibility (ignored, as in the
        reference, :678).
      n_iter: Gibbs sweeps per level (reference Niter).
      addop/diffop/get_mu/get_lambda: per-dim manifold hooks (length-1
        tuples broadcast).  As in the JAX package, only these explicit
        hooks are used: the densities' own hooks enter through ``*``,
        :class:`ProductSampler` and :class:`BatchedProductSampler`.
      add_entropy: if False, each output is the product-Gaussian mean of
        the selected kernels (:455-459).
      partial_dim_mask: ``[ndens][d]`` booleans, the dims each density
        carries information on (:663).
      rand_u/rand_n: injected uniform and normal streams in the reference's
        consumption order ("replay mode", :691-695); otherwise ``key`` (a
        ``torch.Generator``, an int seed or None for the module generator).
      record_labels: also return the per-level labels.
      dtype: float type of the chains (default: the densities').
      plan: ``auto`` (the device-built level hierarchy for device-resident
        densities, the host ball tree otherwise), ``host`` or ``device``
        (ops/device_plan.py).
      select: the keyed path's label selection: ``auto`` (reads
        ``config.GIBBS_SELECT``, see :func:`resolve_select`), ``cdf`` (the
        flat inverse CDF), ``blocked`` (the same draw block by block) or
        ``gumbel`` (argmax of logits plus Gumbel noise, drawn by counter
        from a seed the key gives).  Replay mode always draws with ``cdf``.

    Returns ``(points [d, Np], indices [ndens, Np])`` with 0-based labels,
    plus ``labels [Np, ndens, n_levels]`` if ``record_labels``.
    """
    del an_fcns, an_params
    n_out = npd0 if isinstance(npd0, int) else npd0.npts
    densities = list(densities)
    with span("gibbs", n_out=n_out, replay=rand_u is not None):
        device = densities[0].device
        if any(p.device != device for p in densities):
            raise ValueError("densities must lie on one device")
        hooks = normalize_hooks(addop, diffop, get_mu, get_lambda,
                                densities[0].ndim)
        if (rand_u is None) != (rand_n is None):
            raise ValueError(
                "replay mode needs BOTH streams: pass rand_u (uniforms) and "
                "rand_n (normals) together (reference "
                "src/MSGibbs01.jl:661-662)")
        dtype = dtype or densities[0].dtype
        pl = _get_plan(densities, n_out, dtype, device,
                       _resolve_plan_impl(densities, plan,
                                          rand_u is not None))
        plans = _stack_plans([pl])
        select = resolve_select(select, n_out, pl.offsets[-1][1])
        mask = _mask_tensor(partial_dim_mask, pl.ndens, pl.ndim,
                            device)[None]
        if rand_u is None:
            pts, idx, labels = _gibbs_keyed(
                [make_generator(key, device)], plans, mask, n_out, n_iter,
                add_entropy, dtype, select, hooks)
        else:
            # streams may be over-allocated (the reference sizes randU at
            # Np*Ndens*(Niter+2)*Nlevels, :661); the first n_out*bu /
            # n_out*bn draws are consumed, contiguously
            bu, bn = _stream_sizes(pl.ndens, pl.ndim, pl.n_levels, n_iter)
            stream = lambda r, k: torch.as_tensor(
                np.asarray(r, dtype=np.float64).ravel()[:n_out * k]
                .reshape(1, n_out, k), dtype=dtype, device=device)
            pts, idx, labels = _gibbs_all_chains(
                stream(rand_u, bu), stream(rand_n, bn), plans, mask, n_iter,
                add_entropy, hooks=hooks)
            pts, idx, labels = (pts.transpose(1, 2), idx.transpose(1, 2),
                                labels.transpose(2, 3))
        out = (pts[0], idx[0])
        if record_labels:
            out = out + (labels[0],)
        return out


def product(densities: Sequence[KDE], add_entropy: bool = True,
            key=None) -> KDE:
    """The ``*`` operator: a Gibbs product with Niter=5 sized at the mean
    component count, then an LOOCV refit of the samples on their device
    (reference src/MSGibbs01.jl:707-736).  The densities' manifold hooks
    (:func:`_density_hooks`) drive the product and ride on the output; the
    refit bandwidth stays Euclidean, as the reference's ``kde!(pGM)``."""
    densities = list(densities)
    with span("product", ndens=len(densities)) as attrs:
        addop, diffop, get_mu, get_lambda = _density_hooks(densities)
        kw = dict(addop=addop, diffop=diffop, get_mu=get_mu,
                  get_lambda=get_lambda)
        if len(densities) == 1 and not add_entropy:
            # the reference's #70 short-circuit (src/MSGibbs01.jl:712-716)
            return kde(densities[0].get_points(), **kw)
        n_out = int(round(float(np.mean([p.npts for p in densities]))))
        if attrs is not None:
            attrs["n_out"] = n_out
        pts, _ = prod_appx_ms_gibbs(n_out, densities, n_iter=5,
                                    add_entropy=add_entropy, key=key, **kw)
        return kde(pts, **kw)


def product_batched(density_sets, n_iter: int = 5, add_entropy: bool = True,
                    key=None, mesh=None) -> List[KDE]:
    """Batched ``*`` (``kde_tpu/ops/gibbs.py:915-964``): one batched Gibbs
    draw over ``B`` same-shaped density sets, then one LOOCV refit of all
    ``B x d`` sample rows at once; returns ``B`` product KDEs on the sets'
    device.  With ``mesh`` (see :class:`BatchedProductSampler`) each rank
    draws and refits only its own sets, then gathers the samples and
    bandwidths, so every rank returns all ``B`` products.  No reference
    counterpart: the reference computes each ``*`` serially
    (src/MSGibbs01.jl:707-736)."""
    sets = [list(ds) for ds in density_sets]
    if not sets:
        return []
    n_out = int(round(float(np.mean([p.npts for p in sets[0]]))))
    sampler = BatchedProductSampler(sets, n_out=n_out, n_iter=n_iter,
                                    add_entropy=add_entropy, mesh=mesh)
    pts, _ = sampler._sample_local(key)               # [B_local, d, n]
    b, d, n = pts.shape
    w = torch.full((n,), 1.0 / n, dtype=pts.dtype, device=pts.device)
    lo, hi = _slices_on(n, pts.device)
    # product samples are uniform-weight: the B x d golden searches share
    # one weight vector and run as one batch
    bwds = ksize_rows(pts.reshape(b * d, n), w, lo, hi,
                      impl=select_loo_impl(n, pts.dtype),
                      chunk=int(config.LOOCV_CHUNK)).reshape(b, d)
    pts, bwds = sampler._gather(pts), sampler._gather(bwds)
    var = (bwds ** 2)[:, None, :].expand(-1, n, d)
    addop, diffop, get_mu, get_lambda = sampler.hooks
    return [KDE(pts[i].T, var[i], w, addop=addop, diffop=diffop,
                get_mu=get_mu, get_lambda=get_lambda)
            for i in range(sampler.B)]


class BatchedProductSampler:
    """Products of ``B`` same-shaped density sets as one chain batch
    (``kde_tpu/ops/gibbs.py:997-1135``), the serving path of nonparametric
    belief propagation: every iteration multiplies many message sets of
    the same shape.  All sets share ``(ndens, ndim, per-position npts)``;
    :meth:`refresh` swaps in updated densities of the same shapes.  The
    densities' manifold hooks drive the products: every set must carry the
    identical quadruple (one batch multiplies messages of one variable
    type).

    >>> sampler = BatchedProductSampler([[p1, q1], [p2, q2]], n_out=1000)
    >>> pts, labels = sampler.sample(0)      # [B, d, n_out], [B, ndens, n_out]
    """

    _KEEP = object()

    def __init__(self, density_sets, n_out: int, n_iter: int = 5,
                 add_entropy: bool = True, partial_dim_masks=None,
                 dtype=None, mesh=None, plan: str = "auto"):
        """``plan``: auto|host|device level-hierarchy builder (auto takes
        the device builder for device-resident densities, the refresh path
        of a belief-propagation loop).  ``mesh``: a 1-axis
        ``DeviceMesh`` (kde_tpu_torch.parallel) whose size divides ``B``:
        rank ``r`` of ``S`` builds and draws only sets
        ``r*B/S .. (r+1)*B/S - 1`` (the graph-parallel axis of belief
        propagation), and :meth:`sample` gathers them."""
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh
            if (not isinstance(mesh, DeviceMesh)
                    or len(mesh.mesh_dim_names or ()) != 1):
                raise ValueError("mesh must be a 1-axis "
                                 "torch.distributed DeviceMesh")
        self.mesh = mesh
        self.n_out = n_out
        self.n_iter = n_iter
        self.add_entropy = add_entropy
        self.dtype = dtype
        self.plan_impl = plan
        self._build(density_sets, partial_dim_masks)

    def _build(self, density_sets, partial_dim_masks):
        self._masks_arg = partial_dim_masks     # refresh() default: keep
        sets = [list(ds) for ds in density_sets]
        if not sets:
            raise ValueError("need at least one density set")
        shapes = {(len(ds), ds[0].ndim, tuple(p.npts for p in ds))
                  for ds in sets}
        if len(shapes) != 1:
            raise ValueError("all density sets must share "
                             "(ndens, ndim, per-position npts); "
                             f"got {sorted(shapes)}")
        if len({p.ndim for ds in sets for p in ds}) != 1:
            raise ValueError("kdes must have same dimension "
                             "(reference src/MSGibbs01.jl:721)")
        self.device = sets[0][0].device
        if any(p.device != self.device for ds in sets for p in ds):
            raise ValueError("densities must lie on one device")
        set_hooks = [_density_hooks(ds) for ds in sets]
        if any(h != set_hooks[0] for h in set_hooks[1:]):
            raise ValueError(
                "all density sets in one batch must carry identical "
                "manifold hooks (the hooks describe the shared product "
                "space of the batch; build separate samplers per variable "
                "type)")
        self.hooks = set_hooks[0]
        self._norm_hooks = normalize_hooks(*self.hooks, sets[0][0].ndim)
        self._dtype = self.dtype or sets[0][0].dtype
        impls = {_resolve_plan_impl(ds, self.plan_impl, False) for ds in sets}
        self.B, self.ndens, self.ndim = len(sets), len(sets[0]), sets[0][0].ndim
        if partial_dim_masks is None:
            mask = torch.ones((self.B, self.ndens, self.ndim),
                              dtype=torch.bool, device=self.device)
        else:
            mask = torch.as_tensor(
                np.asarray(partial_dim_masks, dtype=bool)
                .reshape(self.B, self.ndens, self.ndim), device=self.device)
        self.rows = slice(0, self.B)               # the sets this rank runs
        if self.mesh is not None:
            s = self.mesh.size()
            if self.B % s:
                raise ValueError(f"the mesh's {s} ranks do not divide the "
                                 f"B = {self.B} density sets")
            r = self.mesh.get_local_rank()
            self.rows = slice(r * self.B // s, (r + 1) * self.B // s)
        sets, self.mask = sets[self.rows], mask[self.rows]
        if "device" in impls:
            # all sets device-resident (the belief-propagation refresh
            # pattern), or a mix, which takes one builder for the whole
            # batch so that no two sets anneal through differently built
            # hierarchies: every set's plan in one pass
            self.plans = _SetPlans(*batched_device_plans(sets, self.n_out,
                                                         self._dtype))
        else:
            self.plans = _stack_plans([
                _get_plan(ds, self.n_out, self._dtype, self.device, "host")
                for ds in sets])

    def refresh(self, density_sets, partial_dim_masks=_KEEP):
        """Swap in updated densities of the same shapes.
        ``partial_dim_masks`` defaults to keeping the sampler's masks (a BP
        loop refreshes densities only); pass masks, or ``None`` for all
        dims, to change them."""
        if partial_dim_masks is BatchedProductSampler._KEEP:
            partial_dim_masks = self._masks_arg
        self._build(density_sets, partial_dim_masks)

    def _sample_local(self, key=None, select: str = "auto"):
        """This rank's sets: ``(points [B_local, d, n_out], labels
        [B_local, ndens, n_out])``.  Set ``i`` draws from the generator of
        ``split(key, B)[i]`` (with a mesh and a non-int ``key``, of
        ``split(seed, B)[i]`` for one seed drawn on rank 0), so it equals a
        standalone :func:`prod_appx_ms_gibbs` keyed with that seed."""
        select = resolve_select(select, self.n_out,
                                self.plans.offsets[-1][1], batch=self.B)
        if self.mesh is not None:
            from ..parallel.collectives import shared_seed
            key = shared_seed(key, self.device)
        gens = [make_generator(s, self.device)
                for s in split(key, self.B, self.device)[self.rows]]
        pts, idx, _ = _gibbs_keyed(gens, self.plans, self.mask, self.n_out,
                                   self.n_iter, self.add_entropy, self._dtype,
                                   select, self._norm_hooks)
        return pts, idx

    def _gather(self, x):
        """All ``B`` sets' rows of a per-set tensor ``[B_local, ...]``."""
        if self.mesh is None:
            return x
        from ..parallel.collectives import gather_rows
        return gather_rows(x, self.mesh, self.mesh.mesh_dim_names[0], self.B)

    def sample(self, key=None, select: str = "auto"):
        """Returns ``(points [B, d, n_out], labels [B, ndens, n_out])``."""
        with span("sample", sets=self.B, n_out=self.n_out):
            pts, idx = self._sample_local(key, select)
            return self._gather(pts), self._gather(idx)


class ProductSampler:
    """Reusable sampler for repeated products over the same densities: the
    plan is built once and each :meth:`sample` draws a fresh product (the
    serving path of nonparametric belief propagation).  The densities'
    manifold hooks drive the product, as in ``*``.

    >>> sampler = ProductSampler([p, q], n_out=1000, n_iter=5)
    >>> pts, labels = sampler.sample(torch.Generator().manual_seed(0))
    """

    def __init__(self, densities: Sequence[KDE], n_out: int,
                 n_iter: int = 5, add_entropy: bool = True,
                 partial_dim_mask=None, dtype=None, plan: str = "auto"):
        self.densities = list(densities)
        self.device = self.densities[0].device
        if any(p.device != self.device for p in self.densities):
            raise ValueError("densities must lie on one device")
        self.dtype = dtype or self.densities[0].dtype
        self.hooks = _density_hooks(self.densities)
        self._norm_hooks = normalize_hooks(*self.hooks,
                                           self.densities[0].ndim)
        self.n_out = n_out
        self.n_iter = n_iter
        self.add_entropy = add_entropy
        self.plan = _get_plan(self.densities, n_out, self.dtype, self.device,
                              _resolve_plan_impl(self.densities, plan, False))
        self.plans = _stack_plans([self.plan])
        self.mask = _mask_tensor(partial_dim_mask, self.plan.ndens,
                                 self.plan.ndim, self.device)[None]

    def sample(self, key=None, select: str = "auto"):
        """Returns ``(points [d, n_out], labels [ndens, n_out])``."""
        with span("sample", sets=1, n_out=self.n_out):
            select = resolve_select(select, self.n_out,
                                    self.plan.offsets[-1][1])
            pts, idx, _ = _gibbs_keyed([make_generator(key, self.device)],
                                       self.plans, self.mask, self.n_out,
                                       self.n_iter, self.add_entropy,
                                       self.dtype, select, self._norm_hooks)
            return pts[0], idx[0]
