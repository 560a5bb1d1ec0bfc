"""Two samples of draws compared by their first and second moments.

A draw's features are its Euclidean dims as they are and each circular dim
as its cosine and sine (circular moments); the moments compared are the
features and the products of every pair of them (squares included), taken
about the second sample's mean.  Each moment's two sample means give a
two-sample z, ``(m_a - m_b) / sqrt(s_a^2 / n_a + s_b^2 / n_b)``, about a
standard normal where both samples come from one distribution.  Samples may
be weighted by counts (draws of kernel labels, counted).  It imports
nothing of the program.
"""

from __future__ import annotations

import torch


def features(x, circ):
    """``[n, f]``: the Euclidean dims of ``x [n, d]``, then the cosine and
    the sine of each circular dim (``circ [d]``)."""
    x = x.double()
    circ = torch.as_tensor(circ, device=x.device)
    return torch.cat([x[:, ~circ], torch.cos(x[:, circ]),
                      torch.sin(x[:, circ])], 1)


def _moments(f, centre):
    f = f - centre
    i, j = torch.triu_indices(f.shape[1], f.shape[1], device=f.device)
    return torch.cat([f, f[:, i] * f[:, j]], 1)


def _mean_var(m, w):
    n = w.sum()
    mean = (w[:, None] * m).sum(0) / n
    var = (w[:, None] * (m - mean) ** 2).sum(0) / n
    return mean, var, n


def moment_z(a, b, circ, wa=None, wb=None):
    """The largest ``|z|`` over the moments of draws ``a [n_a, d]`` against
    draws ``b [n_b, d]``, weighted by ``wa [n_a]`` / ``wb [n_b]`` (default
    one each)."""
    fa, fb = features(a, circ), features(b, circ)
    wa = torch.ones(fa.shape[0], dtype=fa.dtype, device=fa.device) \
        if wa is None else wa.double()
    wb = torch.ones(fb.shape[0], dtype=fb.dtype, device=fb.device) \
        if wb is None else wb.double()
    centre = (wb[:, None] * fb).sum(0) / wb.sum()
    ma, va, na = _mean_var(_moments(fa, centre), wa)
    mb, vb, nb = _mean_var(_moments(fb, centre), wb)
    z = (ma - mb) / torch.sqrt(va / na + vb / nb)
    return float(z.abs().max())
