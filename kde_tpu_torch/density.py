"""The KDE container and its constructor (ports ``kde_tpu/density.py:38-487``).

A ``KDE`` holds tensors ``points [N, d]``, per-kernel variances
``bw [N, d]`` and normalized ``weights [N]`` on one device, in original
point order, plus NumPy float64 host copies when it was built from NumPy
(the ball tree is built from them without a device-to-host copy).  The
public constructor ``kde(points, bw=None, weights=None)`` follows the
reference's conventions: ``points`` is ``[d, N]``, ``bw`` holds standard
deviations that are squared into variances, a scalar broadcasts across
dims, and omitting ``bw`` selects it by LOOCV (reference src/KDE01.jl:3-84).

Euclidean only: manifold hooks are ROADMAP M8.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import config
from .ops import kernels
from .ops.balltree import FlatBallTree, build_balltree
from .ops.loocv import device_fit_arrays, ksize_bandwidths
from .ops.tiled_eval import tiled_log_eval


class KDE:
    """An n-dimensional Gaussian kernel density estimate,
    ``p(x) = sum_i w_i prod_k N(x_k; mu_ik, bw_ik)`` with ``bw`` stored as
    variances.  Callable like the reference's ``(bd::BallTreeDensity)(pos)``.

    NumPy inputs are copied to ``device`` as ``dtype`` (default
    ``torch.get_default_dtype()``), and their host copies are kept rounded
    through ``dtype`` so host consumers see what the device holds.  Tensor
    inputs keep their device, and their dtype unless ``dtype`` is given."""

    def __init__(self, points, bw, weights, multibandwidth: bool = False,
                 *, device=None, dtype=None):
        tensors = [isinstance(x, torch.Tensor) for x in (points, bw, weights)]
        if not any(tensors):
            dtype = dtype or torch.get_default_dtype()
            device = torch.device(device or "cpu")
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
        self._tree: Optional[FlatBallTree] = None

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

    # ---- accessors (reference src/KDE01.jl:91-136) --------------------------

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

    def marginal(self, dims: Sequence[int]) -> "KDE":
        """Marginal KDE over the selected dims (reference src/KDE01.jl:143-153)."""
        dims = list(dims)
        if self._host_points is not None:
            return KDE(self._host_points[:, dims], self._host_bw[:, dims],
                       self._host_weights, self.multibandwidth,
                       device=self.device, dtype=self.dtype)
        return KDE(self.points[:, dims], self.bw[:, dims], self.weights,
                   self.multibandwidth)

    # ---- evaluation ---------------------------------------------------------

    def log_eval(self, pos, chunk: Optional[int] = None) -> torch.Tensor:
        """``log p`` at ``pos`` (``[d, M]``, or ``[M]`` for a 1-D density).

        Above ``config.DIRECT_PAIR_LIMIT`` query*component pairs a float32
        density takes the tiled route (the CUDA kernel on the card, its
        plain twin on the CPU); other dtypes chunk the query axis."""
        q = _as_query(pos, self.ndim, self.dtype, self.device)
        if chunk is None and q.shape[0] * self.npts > config.DIRECT_PAIR_LIMIT:
            if kernels.use_tiled_eval(self.dtype):
                return tiled_log_eval(q, self.points, self.bw, self.weights)
            chunk = max(1, config.DIRECT_PAIR_LIMIT // self.npts)
        return kernels.log_eval(q, self.points, self.bw, self.weights,
                                chunk=chunk)

    def evaluate(self, pos, lv_flag: bool = False, err_tol: float = 1e-3,
                 chunk: Optional[int] = None) -> torch.Tensor:
        """Density values at ``pos``; with ``lv_flag``, leave-one-out at the
        KDE's own points (reference evaluateDualTree,
        src/DualTree01.jl:370-421).  ``err_tol`` is accepted for API
        compatibility; evaluation is exact."""
        del err_tol
        if lv_flag:
            return torch.exp(kernels.log_eval_loo(self.points, self.bw,
                                                  self.weights))
        return torch.exp(self.log_eval(pos, chunk=chunk))

    __call__ = evaluate

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


def kde(points, bw=None, weights=None, *, device="cpu", dtype=None) -> KDE:
    """Construct a KDE (the reference's ``kde!``, src/KDE01.jl:3-84).

    Args:
      points: ``[d, N]`` (column per point) or ``[N]`` for 1-D data.
      bw: bandwidth *standard deviations*: a scalar (broadcast to all dims),
        ``[d]`` per dim, or ``[d, N]`` per kernel; ``None`` selects per-dim
        bandwidths by LOOCV.
      weights: ``[N]`` kernel weights (normalized here).
      device, dtype: where and in what type NumPy inputs go (default
        ``torch.get_default_dtype()``).  A tensor ``points`` keeps its own
        device, its dtype unless ``dtype`` is given, and is fitted there.
    """
    if isinstance(points, torch.Tensor):
        return _kde_tensor(points, bw, weights, dtype)
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
    return KDE(pts_nd, var, w, multibw, device=device, dtype=dtype)


def _kde_tensor(points: torch.Tensor, bw, weights, dtype) -> KDE:
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
        return KDE(pts_nd, var, w)
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
    return KDE(pts.T, var, w, multibw)
