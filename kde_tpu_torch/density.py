"""The KDE container and its constructor (ports ``kde_tpu/density.py:38-487``).

A ``KDE`` holds tensors ``points [N, d]``, per-kernel variances
``bw [N, d]`` and normalized ``weights [N]`` on one device, in original
point order, plus NumPy float64 host copies when it was built from NumPy
(the ball tree is built from them without a device-to-host copy).  The
public constructor ``kde(points, bw=None, weights=None)`` follows the
reference's conventions: ``points`` is ``[d, N]``, ``bw`` holds standard
deviations that are squared into variances, a scalar broadcasts across
dims, and omitting ``bw`` selects it by LOOCV (reference src/KDE01.jl:3-84).
A density may carry per-dimension manifold hooks (manifolds.py): evaluation
then takes the ``diffop`` path, and products run on the manifold.  Small
evaluations of a NumPy-built density at NumPy queries take the float64
route of ops/host_small.py (``config.HOST_EVAL_LIMIT``), as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import config, manifolds
from .ops import host_small, kernels
from .ops.balltree import FlatBallTree, build_balltree
from .ops.loocv import device_fit_arrays, ksize_bandwidths
from .utils.spans import span


class KDE:
    """An n-dimensional Gaussian kernel density estimate,
    ``p(x) = sum_i w_i prod_k N(x_k; mu_ik, bw_ik)`` with ``bw`` stored as
    variances.  Callable like the reference's ``(bd::BallTreeDensity)(pos)``.

    NumPy inputs are copied to ``device`` (default ``config.DEVICE``, the
    card) as ``dtype`` (default ``torch.get_default_dtype()``), and their
    host copies are kept rounded
    through ``dtype`` so host consumers see what the device holds.  Tensor
    inputs keep their device, and their dtype unless ``dtype`` is given.
    ``addop``/``diffop``/``get_mu``/``get_lambda`` are the manifold hooks,
    one callable per dim or a length-1 tuple that broadcasts."""

    def __init__(self, points, bw, weights, multibandwidth: bool = False,
                 addop=None, diffop=None, get_mu=None, get_lambda=None,
                 *, device=None, dtype=None):
        tensors = [isinstance(x, torch.Tensor) for x in (points, bw, weights)]
        if not any(tensors):
            dtype = dtype or torch.get_default_dtype()
            device = config.default_device(device)
            np_dt = torch.empty((), dtype=dtype).numpy().dtype
            rt = lambda x: (np.asarray(x, dtype=np.float64)
                            .astype(np_dt).astype(np.float64))
            self._host_points = rt(points)
            self._host_bw = rt(bw)
            self._host_weights = rt(weights)
            host = (self._host_points, self._host_bw, self._host_weights)
            self.points, self.bw, self.weights = (
                torch.as_tensor(x, dtype=dtype, device=device).contiguous()
                for x in host)
        else:
            ref = (points, bw, weights)[tensors.index(True)]
            device = ref.device if device is None else torch.device(device)
            dtype = dtype or ref.dtype
            self.points, self.bw, self.weights = (
                torch.as_tensor(x, dtype=dtype, device=device).contiguous()
                for x in (points, bw, weights))
            self._host_points = self._host_bw = self._host_weights = None
        n, d = self.points.shape
        if self.bw.shape != (n, d) or self.weights.shape != (n,):
            raise ValueError(f"KDE needs points/bw [N, d] and weights [N]; "
                             f"got {tuple(self.points.shape)}, "
                             f"{tuple(self.bw.shape)}, "
                             f"{tuple(self.weights.shape)}")
        self.multibandwidth = bool(multibandwidth)
        self.addop = manifolds.broadcast_ops(addop, d)
        self.diffop = manifolds.broadcast_ops(diffop, d)
        self.get_mu = manifolds.broadcast_ops(get_mu, d)
        self.get_lambda = manifolds.broadcast_ops(get_lambda, d)
        self._tree: Optional[FlatBallTree] = None
        self._f64 = None

    # ---- basic properties ---------------------------------------------------

    @property
    def dtype(self) -> torch.dtype:
        return self.points.dtype

    @property
    def device(self) -> torch.device:
        return self.points.device

    @property
    def npts(self) -> int:
        return self.points.shape[0]

    @property
    def ndim(self) -> int:
        return self.points.shape[1]

    @property
    def tree(self) -> FlatBallTree:
        """Host ball tree (built on first use; ops/balltree.py)."""
        if self._tree is None:
            bw = self._host_var()
            self._tree = build_balltree(
                self.host_points().T, self.host_weights(),
                bw if self.multibandwidth else bw[0])
        return self._tree

    @property
    def _eval_diffop(self):
        if manifolds.is_euclidean(self.diffop, manifolds.euclid_diff):
            return None
        return self.diffop

    @property
    def _hooks(self) -> dict:
        """The manifold hooks as keyword arguments of :func:`kde`."""
        return {attr: getattr(self, attr)
                for attr, _ in manifolds.HOOK_DEFAULTS}

    # ---- accessors (reference src/KDE01.jl:91-136) --------------------------

    def _small_arrays(self):
        """``(points, var, weights)``: the host copies as float64 tensors on
        the density's device, the small routes' inputs (made once)."""
        if self._f64 is None:
            self._f64 = tuple(
                torch.as_tensor(x, dtype=torch.float64,
                                device=self.device).contiguous()
                for x in (self._host_points, self._host_bw,
                          self._host_weights))
        return self._f64

    def _host_var(self) -> np.ndarray:
        if self._host_bw is not None:
            return self._host_bw
        return self.bw.detach().cpu().double().numpy()

    def get_points(self) -> torch.Tensor:
        """Kernel centers, ``[d, N]`` (reference orientation)."""
        return self.points.T

    def host_points(self) -> np.ndarray:
        """``[d, N]`` kernel centers as NumPy float64."""
        if self._host_points is not None:
            return self._host_points.T
        return self.points.detach().cpu().double().numpy().T

    def host_bw_std(self) -> np.ndarray:
        """``[d, N]`` per-kernel std-dev bandwidths as NumPy float64."""
        return np.sqrt(self._host_var()).T

    def host_weights(self) -> np.ndarray:
        if self._host_weights is not None:
            return self._host_weights
        return self.weights.detach().cpu().double().numpy()

    def get_bw(self, ind=None) -> torch.Tensor:
        """Per-kernel bandwidths as standard deviations, ``[d, N]`` or the
        selected columns (reference getBW, src/KDE01.jl:109-120)."""
        s = torch.sqrt(self.bw).T
        return s if ind is None else s[:, torch.as_tensor(ind)]

    def get_weights(self, ind=None) -> torch.Tensor:
        return (self.weights if ind is None
                else self.weights[torch.as_tensor(ind)])

    def bw_min(self, i: int = 0) -> np.ndarray:
        """Per-dim lower variance bound below tree node ``i`` (reference
        ``bwMin``, src/BallTreeDensity01.jl:98-99); a uniform-bandwidth
        density returns the shared variance for every node."""
        t = self.tree
        return np.asarray(t.bw_min[i] if t.multibandwidth else t.bw_min)

    def bw_max(self, i: int = 0) -> np.ndarray:
        """Per-dim upper variance bound below tree node ``i`` (reference
        ``bwMax``, src/BallTreeDensity01.jl:95-96)."""
        t = self.tree
        return np.asarray(t.bw_max[i] if t.multibandwidth else t.bw_max)

    def marginal(self, dims: Sequence[int]) -> "KDE":
        """Marginal KDE over the selected dims, with their hooks (reference
        src/KDE01.jl:143-153)."""
        dims = list(dims)
        hooks = {k: None if ops is None else tuple(ops[i] for i in dims)
                 for k, ops in self._hooks.items()}
        if self._host_points is not None:
            return KDE(self._host_points[:, dims], self._host_bw[:, dims],
                       self._host_weights, self.multibandwidth, **hooks,
                       device=self.device, dtype=self.dtype)
        return KDE(self.points[:, dims], self.bw[:, dims], self.weights,
                   self.multibandwidth, **hooks)

    # ---- evaluation ---------------------------------------------------------

    def _small_eval_ok(self, m: int) -> bool:
        """Take the float64 small route (ops/host_small.py) for ``m``
        queries that are not a tensor (the density's own points for LOO)?
        Yes for a density built from NumPy (host copies present), with no
        ``diffop``, and ``m*N*d <= config.HOST_EVAL_LIMIT``
        (``kde_tpu/density.py:254-266``)."""
        return (self._host_points is not None
                and self._eval_diffop is None
                and m * self.npts * self.ndim <= config.HOST_EVAL_LIMIT)

    def log_eval(self, pos, chunk: Optional[int] = None) -> torch.Tensor:
        """``log p`` at ``pos`` (``[d, M]``, or ``[M]`` for a 1-D density).

        A small NumPy query of a NumPy-built density (``_small_eval_ok``)
        is evaluated in float64 on the density's device and gives float64,
        whatever the density's dtype, as the JAX package's host route.
        Otherwise, without ``chunk``, above ``config.DIRECT_PAIR_LIMIT``
        query*component pairs a float32 Euclidean density takes the tiled
        route (the CUDA kernel on the card, its plain twin on the CPU);
        other densities chunk the query axis (``kernels.log_eval_gated``).
        A manifold density evaluates with its ``diffop``."""
        if pos is not None and not isinstance(pos, torch.Tensor):
            q = np.asarray(pos, dtype=np.float64)
            if self._small_eval_ok(q.size if q.ndim == 1 else q.shape[-1]):
                return host_small.log_eval_small(
                    _as_query(q, self.ndim, torch.float64, self.device),
                    *self._small_arrays())
        q = _as_query(pos, self.ndim, self.dtype, self.device)
        if chunk is None:
            return kernels.log_eval_gated(q, self.points, self.bw,
                                          self.weights, self._eval_diffop)
        return kernels.log_eval(q, self.points, self.bw, self.weights,
                                self._eval_diffop, chunk=chunk)

    def evaluate(self, pos, lv_flag: bool = False, err_tol: float = 1e-3,
                 chunk: Optional[int] = None) -> torch.Tensor:
        """Density values at ``pos``; with ``lv_flag``, leave-one-out at the
        KDE's own points (reference evaluateDualTree,
        src/DualTree01.jl:370-421).  ``err_tol`` is accepted for API
        compatibility; evaluation is exact.  Small evaluations take the
        float64 route as :meth:`log_eval` says, LOO ones too."""
        del err_tol
        if lv_flag:
            if self._small_eval_ok(self.npts):
                return torch.exp(host_small.log_eval_loo_small(
                    *self._small_arrays()))
            return torch.exp(kernels.log_eval_loo(
                self.points, self.bw, self.weights, self._eval_diffop))
        return torch.exp(self.log_eval(pos, chunk=chunk))

    __call__ = evaluate

    @property
    def kernel_type(self):
        """Kernel family (reference ``getType``/``GaussianKer``,
        src/BallTreeDensity01.jl:3-5,49)."""
        from .models.kernels import GaussianKernel
        return GaussianKernel

    def __mul__(self, other: "KDE") -> "KDE":
        from .ops.gibbs import product   # gibbs imports this module
        return product([self, other])

    def __repr__(self) -> str:
        bws = np.round(np.sqrt(self._host_var()[0]), 6)
        return (f"KDE:\n  dims: {self.ndim}\n  Npts: {self.npts}\n"
                f"  bws:  {bws.tolist()}")


def _as_query(pos, ndim: int, dtype, device) -> torch.Tensor:
    """``[d, M]`` (or ``[M]`` for 1-D) positions -> contiguous ``[M, d]``."""
    pos = torch.as_tensor(pos, dtype=dtype, device=device)
    if pos.dim() == 1:
        if ndim != 1:
            raise ValueError(
                "vector query positions are only supported for 1-D densities "
                "(one value per query point); pass a [d, M] matrix instead")
        return pos[:, None].contiguous()
    if pos.shape[0] != ndim:
        raise ValueError(f"query must be [d={ndim}, M], got {tuple(pos.shape)}")
    return pos.T.contiguous()


def kde(points, bw=None, weights=None, addop=None, diffop=None, get_mu=None,
        get_lambda=None, *, device=None, dtype=None) -> KDE:
    """Construct a KDE (the reference's ``kde!``, src/KDE01.jl:3-84).

    Args:
      points: ``[d, N]`` (column per point) or ``[N]`` for 1-D data.
      bw: bandwidth *standard deviations*: a scalar (broadcast to all dims),
        ``[d]`` per dim, or ``[d, N]`` per kernel; ``None`` selects per-dim
        bandwidths by LOOCV.
      weights: ``[N]`` kernel weights (normalized here).
      addop/diffop/get_mu/get_lambda: per-dimension manifold hooks
        (length-1 tuples broadcast; manifolds.py).  The LOOCV bandwidth
        search itself is Euclidean, as the reference's.
      device, dtype: where and in what type NumPy inputs go (default
        ``config.DEVICE``, the card, and ``torch.get_default_dtype()``).  A
        tensor ``points`` keeps its own device, its dtype unless ``dtype``
        is given, and is fitted there.
    """
    hooks = dict(addop=addop, diffop=diffop, get_mu=get_mu,
                 get_lambda=get_lambda)
    with span("kde", fit=bw is None) as attrs:
        if isinstance(points, torch.Tensor):
            out = _kde_tensor(points, bw, weights, dtype, hooks)
        else:
            out = _kde_numpy(points, bw, weights, device, dtype, hooks)
        if attrs is not None:
            attrs.update(n=out.npts, d=out.ndim)
    return out


def _kde_numpy(points, bw, weights, device, dtype, hooks) -> KDE:
    """:func:`kde` for NumPy (or nested lists): the density goes to
    ``device``."""
    device = config.default_device(device)
    pts = np.asarray(points, dtype=np.float64)
    if pts.ndim == 1:
        pts = pts[None, :]
    d, n = pts.shape
    pts_nd = pts.T
    if weights is None:
        w = np.full(n, 1.0 / n)
    else:
        w = np.asarray(weights, dtype=np.float64).reshape(n)
        w = w / w.sum()
    dtype = dtype or torch.get_default_dtype()
    if bw is None:
        bwds = ksize_bandwidths(pts_nd, w, dtype=dtype, device=device)
        var = np.tile(bwds ** 2, (n, 1))
        multibw = False
    else:
        bwa = np.asarray(bw, dtype=np.float64)
        if bwa.ndim == 0 or bwa.size == 1:
            bwa = np.full(d, float(np.ravel(bwa)[0]))
        if bwa.ndim == 1:
            var = np.tile(bwa.reshape(d) ** 2, (n, 1))
            multibw = False
        else:
            var = (bwa.reshape(d, n) ** 2).T
            multibw = True
    return KDE(pts_nd, var, w, multibw, **hooks, device=device, dtype=dtype)


def _kde_tensor(points: torch.Tensor, bw, weights, dtype, hooks) -> KDE:
    """:func:`kde` for a tensor: everything stays on its device."""
    if dtype is None:
        dtype = (points.dtype if points.is_floating_point()
                 else torch.get_default_dtype())
    pts = points.to(dtype)
    if pts.dim() == 1:
        pts = pts[None, :]
    d, n = pts.shape
    if bw is None:
        pts_nd, var, w = device_fit_arrays(pts, weights)
        return KDE(pts_nd, var, w, **hooks)
    dev = pts.device
    if weights is None:
        w = torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
    else:
        w = torch.as_tensor(weights, dtype=dtype, device=dev).reshape(n)
        w = w / w.sum()
    bwa = torch.as_tensor(bw, dtype=dtype, device=dev)
    if bwa.numel() == 1:
        bwa = bwa.reshape(1).expand(d)
    if bwa.dim() == 1:
        var = (bwa.reshape(d) ** 2)[None, :].expand(n, d)
        multibw = False
    else:
        var = (bwa.reshape(d, n) ** 2).T
        multibw = True
    return KDE(pts.T, var, w, multibw, **hooks)
