"""The program under test, ``kde_tpu_torch``, as the drivers reach it:
through its public entry points only (``kde``, ``product``,
``BatchedProductSampler`` and the circular hooks of ``manifolds``)."""

from __future__ import annotations


def port():
    import kde_tpu_torch
    return kde_tpu_torch


def hooks(config) -> dict:
    """The configuration's per-dim manifold hooks as keyword arguments of
    ``kde``: none for an all-Euclidean belief."""
    kinds = [d["hook"] for d in config["dims"]]
    if all(k == "euclid" for k in kinds):
        return {}
    m = port().manifolds
    table = {"euclid": (m.euclid_add, m.euclid_diff, m.euclid_mu,
                        m.euclid_lambda),
             "circular": (m.circular_add, m.circular_diff, m.circular_mu,
                          m.circular_lambda)}
    quads = [table[k] for k in kinds]
    return {name: tuple(q[i] for q in quads)
            for i, name in enumerate(("addop", "diffop", "get_mu",
                                      "get_lambda"))}


def density(points, bw, config):
    """A device-resident belief: ``points [n, d]`` with the bandwidths
    (standard deviations) ``bw [d]``, uniform weights."""
    return port().kde(points.T, bw, **hooks(config))
