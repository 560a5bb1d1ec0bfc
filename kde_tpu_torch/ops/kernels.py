"""Dense Gaussian-mixture evaluation and LOO entropies (ports
``kde_tpu/ops/kernels.py:39-286``).

For Euclidean densities the quadratic form of forward evaluation is the
matmul expansion

    sum_k (q_mk - mu_nk)^2 / s_nk + log s_nk
      =  (q^2) @ (1/s)^T  -  2 q @ (mu/s)^T  +  [sum_k mu^2/s + log s]_n ,

followed by a weighted log-sum-exp over components.  The expansion cancels
digits: on CUDA it must run in full float32, with TF32 matmuls off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
Above the size gates of ``config`` float32 problems take the tiled route
(ops/tiled_eval.py) and float64 problems chunk the query axis, as the JAX
package's f32 guard on its Pallas route does.  A manifold ``diffop`` (one
callable per dim, see manifolds.py) replaces the matmuls with per-dimension
broadcast differences and never takes the tiled route: the kernel computes
a Euclidean difference.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from .. import config
from .tiled_eval import tiled_log_eval

LOG_2PI = math.log(2.0 * math.pi)


def use_tiled_eval(dtype, diffop=None) -> bool:
    """Route an above-gate evaluation through :func:`tiled_log_eval`?
    (Counterpart of ``kde_tpu.ops.kernels.use_pallas_eval``.)  Yes for
    float32 Euclidean densities: on a CUDA tensor the wrapper launches the
    kernel, on a CPU tensor it takes the kernel's plain twin.  float64 and
    manifold (``diffop``) densities take the chunked path."""
    return dtype == torch.float32 and diffop is None


def pairwise_quad(query: torch.Tensor, means: torch.Tensor,
                  var: torch.Tensor,
                  diffop: Optional[Sequence[Callable]] = None
                  ) -> torch.Tensor:
    """``[M, N]`` matrix of
    ``sum_k (diff(q_mk, mu_nk)^2 / var_nk + log var_nk)``: the matmul form
    (see module docstring) for ``diffop=None``, per-dimension broadcast
    differences otherwise."""
    logdet = torch.log(var).sum(dim=1)                       # [N]
    if diffop is None:
        inv = 1.0 / var
        a = (query * query) @ inv.T
        b = query @ (means * inv).T
        c = (means * means * inv).sum(dim=1)
        return a - 2.0 * b + (c + logdet)[None, :]
    quad = logdet[None, :]
    for k, op in enumerate(diffop):
        delta = op(query[:, k:k + 1], means[None, :, k])     # [M, N]
        quad = quad + delta * delta / var[None, :, k]
    return quad


def log_gauss_mixture(query: torch.Tensor, means: torch.Tensor,
                      var: torch.Tensor, log_weights: torch.Tensor,
                      diffop: Optional[Sequence[Callable]] = None,
                      exclude: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``log p(x_m) = logsumexp_n [log w_n - quad_mn / 2] - d/2 log 2pi``;
    ``exclude [M]`` masks component ``exclude[m]`` out of query ``m``."""
    d = query.shape[1]
    logits = log_weights[None, :] - 0.5 * pairwise_quad(query, means, var,
                                                         diffop)
    if exclude is not None:
        n = means.shape[0]
        cols = torch.arange(n, device=query.device)
        logits = logits.masked_fill(exclude[:, None] == cols[None, :],
                                    -math.inf)
    return torch.logsumexp(logits, dim=1) - 0.5 * d * LOG_2PI


def log_eval(query: torch.Tensor, means: torch.Tensor, var: torch.Tensor,
             weights: torch.Tensor,
             diffop: Optional[Sequence[Callable]] = None,
             chunk: Optional[int] = None,
             loo_diag: Optional[int] = None) -> torch.Tensor:
    """``log p(x)`` for each query row, in query blocks of ``chunk`` rows
    when given (bounds the live ``[chunk, N]`` logits); with ``loo_diag``,
    query ``m`` leaves out component ``m + loo_diag``."""
    logw = torch.log(weights)
    m = query.shape[0]

    def block(s, e):
        exclude = None
        if loo_diag is not None:
            exclude = torch.arange(s + loo_diag, e + loo_diag,
                                   device=query.device)
        return log_gauss_mixture(query[s:e], means, var, logw, diffop,
                                 exclude)
    if chunk is None or m <= chunk:
        return block(0, m)
    return torch.cat([block(s, min(s + chunk, m))
                      for s in range(0, m, chunk)])


def log_eval_gated(query: torch.Tensor, means: torch.Tensor,
                   var: torch.Tensor, weights: torch.Tensor,
                   diffop: Optional[Sequence[Callable]] = None,
                   loo_diag: Optional[int] = None) -> torch.Tensor:
    """:func:`log_eval` with the size gate of ``KDE.log_eval``
    (``kde_tpu/density.py:287-301``): above ``config.DIRECT_PAIR_LIMIT``
    query*component pairs a float32 Euclidean density takes the tiled
    route, anything else query blocks that keep the live logits within the
    limit.  With ``loo_diag`` query ``m`` leaves out component
    ``m + loo_diag`` on every route (a shard of the ``N x N`` LOO pairs
    passes its rows' global start minus its components'; a value that
    puts no row's column in ``[0, N)`` leaves out nothing)."""
    n = means.shape[0]
    chunk = None
    if query.shape[0] * n > config.DIRECT_PAIR_LIMIT:
        if use_tiled_eval(means.dtype, diffop):
            loo = {} if loo_diag is None else dict(loo=True, diag=loo_diag)
            return tiled_log_eval(query, means, var, weights, **loo)
        chunk = max(1, config.DIRECT_PAIR_LIMIT // n)
    return log_eval(query, means, var, weights, diffop, chunk=chunk,
                    loo_diag=loo_diag)


def log_eval_loo(points: torch.Tensor, var: torch.Tensor,
                 weights: torch.Tensor,
                 diffop: Optional[Sequence[Callable]] = None) -> torch.Tensor:
    """Leave-one-out log-density of a KDE at its own centers,
    ``log( sum_{i != j} w_i K(x_j; x_i) / (1 - w_j) )``
    (reference src/DualTree01.jl:146,222-227,333-336).

    With a ``diffop`` the evaluation is dense and unchunked, as in the JAX
    package (``kde_tpu/ops/kernels.py:152-155``): at N = 20,000 its few
    ``[N, N]`` float32 temporaries take 1.6 GB each."""
    n = points.shape[0]
    if diffop is None and n * n > config.DIRECT_PAIR_LIMIT:
        if use_tiled_eval(points.dtype):
            return (tiled_log_eval(points, points, var, weights, loo=True)
                    - torch.log1p(-weights))
        return log_eval_loo_chunked(points, var, weights,
                                    max(1, config.DIRECT_PAIR_LIMIT // n))
    lp = log_eval(points, points, var, weights, diffop, loo_diag=0)
    return lp - torch.log1p(-weights)


def log_eval_loo_chunked(points: torch.Tensor, var: torch.Tensor,
                         weights: torch.Tensor, chunk: int) -> torch.Tensor:
    """:func:`log_eval_loo` in ``chunk``-row query blocks."""
    return (log_eval(points, points, var, weights, chunk=chunk, loo_diag=0)
            - torch.log1p(-weights))


def eval_avg_logl_from_logp(logp: torch.Tensor,
                            weights: torch.Tensor) -> torch.Tensor:
    """Weighted average log-likelihood with the reference's zero-likelihood
    guard (src/DualTree01.jl:461-468): a positive-weight query with
    ``logp == -inf`` makes the result ``-inf``; zero-weight queries add
    nothing."""
    pos = weights > 0
    safe = torch.where(pos, logp, torch.zeros_like(logp))
    ll = torch.where(pos, weights * safe, torch.zeros_like(logp)).sum()
    bad = (torch.isneginf(logp) & pos).any()
    return torch.where(bad, torch.full_like(ll, -math.inf), ll)


def entropy_kernel(points: torch.Tensor, var: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """``H = - sum_j w_j log p_-j(x_j)`` (reference src/DualTree01.jl:505-508)."""
    return -eval_avg_logl_from_logp(log_eval_loo(points, var, weights),
                                    weights)


def loo_pairwise_d2(points: torch.Tensor) -> torch.Tensor:
    """``[d, N, N]`` squared pairwise differences of ``d`` independent 1-D
    rows ``[d, N]``, ``+inf`` on the diagonal (the LOO mask)."""
    diff = points[:, :, None] - points[:, None, :]
    d2 = diff * diff
    eye = torch.eye(points.shape[1], dtype=torch.bool, device=points.device)
    return d2.masked_fill(eye[None], math.inf)


def loo_entropy_given_d2(d2: torch.Tensor, var: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """``[d]`` LOO entropies of 1-D KDEs from precomputed distances, with
    the ``1/(1-w_j)`` rescale and the zero-likelihood guards of
    :func:`eval_avg_logl_from_logp` (a positive-weight point with p == 0
    gives +inf)."""
    logw = torch.log(weights)
    logits = (logw[None, None, :]
              - 0.5 * (d2 / var[:, None, None]
                       + torch.log(var)[:, None, None]))      # [d, N, N]
    lse = torch.logsumexp(logits, dim=2)                      # [d, N]
    logp = lse - 0.5 * LOG_2PI - torch.log1p(-weights)[None, :]
    pos = weights[None, :] > 0
    zero = torch.zeros_like(logp)
    ll = torch.where(pos, weights[None, :] * torch.where(pos, logp, zero),
                     zero).sum(dim=1)
    bad = (torch.isneginf(logp) & pos).any(dim=1)
    return torch.where(bad, torch.full_like(ll, math.inf), -ll)


def batched_loo_entropy(points: torch.Tensor, var_scale: torch.Tensor,
                        base_var: torch.Tensor, weights: torch.Tensor,
                        impl: str = "dense", chunk: int = 1024
                        ) -> torch.Tensor:
    """Entropies of ``d`` independent 1-D KDEs ``points [d, N]`` with
    variances ``var_scale * base_var`` (``[d]`` each) and shared weights
    ``[N]`` -- the LOOCV probe for all dimensions at once.

    ``impl``: ``dense`` runs :func:`entropy_kernel` per row, ``chunk`` takes
    query blocks of ``chunk`` rows, ``tiled`` runs :func:`tiled_log_eval`
    (the JAX package's ``pallas`` route)."""
    if impl not in ("dense", "chunk", "tiled"):
        raise ValueError(f"impl must be dense|chunk|tiled, got {impl!r}")
    n = points.shape[1]
    var = var_scale * base_var
    outs = []
    for i in range(points.shape[0]):
        p = points[i, :, None].contiguous()
        v = var[i].reshape(1, 1).expand(n, 1).contiguous()
        if impl == "tiled":
            logp = (tiled_log_eval(p, p, v, weights, loo=True)
                    - torch.log1p(-weights))
            outs.append(-eval_avg_logl_from_logp(logp, weights))
        elif impl == "chunk":
            logp = log_eval_loo_chunked(p, v, weights, chunk)
            outs.append(-eval_avg_logl_from_logp(logp, weights))
        else:
            outs.append(entropy_kernel(p, v, weights))
    return torch.stack(outs)
