"""The plain reference and the roofline arithmetic against hand counts and
exact enumeration at tiny sizes."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench.bounds import hierarchy, k3, k4
from portbench.bounds.roofline import PEAKS
from portbench.reference import loocv, moments, msgibbs

RATE = PEAKS["sms"] * PEAKS["sm_clock_hz"]


def _belief(rng, n, d, scale=1.0):
    mu = torch.tensor(rng.normal(size=(n, d)) * scale)
    var = torch.tensor(rng.uniform(0.05, 0.3, size=d))
    lw = torch.log(torch.tensor(rng.dirichlet(np.ones(n))))
    return mu, var, lw


def test_residual_by_hand():
    rng = np.random.default_rng(2)
    circ = torch.tensor([False, True])
    p, q = _belief(rng, 6, 2), _belief(rng, 5, 2)
    labels = torch.tensor([[0, 1], [3, 4], [5, 0]])
    x = torch.tensor([[0.1, 3.1], [-0.2, -3.0], [1.0, 0.0]],
                     dtype=torch.float64)
    res = msgibbs.labelled_residual(x, labels, [p, q], circ)
    i, j = labels[0].tolist()
    v1, v2 = p[1], q[1]
    mu_x = (v2[0] * p[0][i, 0] + v1[0] * q[0][j, 0]) / (v1[0] + v2[0])
    sd_x = math.sqrt(float(v1[0] * v2[0] / (v1[0] + v2[0])))
    assert float(res[0, 0]) == pytest.approx(float(0.1 - mu_x) / sd_x,
                                             abs=1e-12)
    # on the circular dim the offset wraps
    dth = float(q[0][j, 1] - p[0][i, 1])
    dth -= 2 * math.pi * round(dth / (2 * math.pi))
    mu_t = float(p[0][i, 1]) + float(v1[1] / (v1[1] + v2[1])) * dth
    off = 3.1 - mu_t
    off -= 2 * math.pi * round(off / (2 * math.pi))
    sd_t = math.sqrt(float(v1[1] * v2[1] / (v1[1] + v2[1])))
    assert float(res[0, 1]) == pytest.approx(off / sd_t, abs=1e-9)


def test_loo_entropy_by_double_loop():
    rng = np.random.default_rng(3)
    x = rng.normal(size=7)
    w = np.full(7, 1 / 7)
    var = 0.3
    want = 0.0
    for j in range(7):
        s = sum(w[i] * math.exp(-0.5 * (x[j] - x[i]) ** 2 / var)
                / math.sqrt(2 * math.pi * var) for i in range(7) if i != j)
        want -= w[j] * math.log(s / (1 - w[j]))
    got = loocv.loo_entropy(torch.tensor(x), torch.tensor(w), var)
    assert got == pytest.approx(want, rel=1e-12)


def test_golden_finds_the_grid_minimum():
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=300))
    bw, probes = loocv.ksize(x[:, None], 1e-3)
    base, ax, bx, cx = loocv.bracket(x)
    w = torch.full((300,), 1 / 300, dtype=torch.float64)
    grid = np.linspace(ax, cx, 4001)[1:]
    f = [loocv.loo_entropy(x, w, (base * a) ** 2) for a in grid]
    best = grid[int(np.argmin(f))] * base
    assert bw[0] == pytest.approx(best, rel=2e-3)
    assert probes[0] > 2


def test_bracket_and_widths_match_the_port():
    """The benchmark's copies of the tree's rules give the port's own
    numbers (which the benchmark never calls)."""
    from kde_tpu_torch.ops import device_plan, loocv as port_loocv
    rng = np.random.default_rng(5)
    for n in (2, 3, 17, 100, 257):
        row = torch.tensor(rng.normal(size=n))
        lo, hi = port_loocv._internal_slices(n)
        want = port_loocv.bracket_rows(row[None], torch.as_tensor(lo),
                                       torch.as_tensor(hi))
        got = loocv.bracket(row)
        assert got == pytest.approx([float(t[0]) for t in want], rel=1e-12)
        lv = hierarchy.n_levels(n, [n])
        assert [w for w, _ in hierarchy.widths(n, lv)] == \
            device_plan.level_widths(n, lv)


def test_k3_bound_by_hand():
    # 1 set of 2 densities of 2 leaves, d = 1, 2 chains, 1 sweep: 2 levels
    # of 2 leaves each (uniform bandwidth): per (density, level) SFU 2 * (2
    # * (2 + 1 - 1) + 1) on the sweep and 2 * 2 * 2 + 1 on the conditioning
    # step, FP32 2 * 2 * 2 * 10; bytes 8 nodes * 20 + 26 stream words * 4
    # + 2 chains * (4 + 8 * 2 * 3)
    sfu, fp32, nbytes = 4 * 19, 4 * 80, 8 * 20 + 26 * 4 + 2 * 52
    want = max(sfu / (16 * RATE), fp32 / (128 * RATE),
               nbytes / PEAKS["hbm_bytes_per_s"])
    assert k3.chain_seconds(1, [2, 2], 1, 2, 1, 4) == pytest.approx(want)
    # wide levels: operations bound it
    s = k3.chain_seconds(6, [1000, 1000], 2, 1000, 5, 4)
    assert s > 1e-4


def test_k4_bound_by_hand():
    n, probes = 1000, [12, 13]
    pairs = n * (n - 1)
    want = max(pairs * 25 / (16 * RATE),
               (4 * pairs * 25 + 3 * pairs * 2) / (128 * RATE),
               4 * (2 * n + n + 10) / PEAKS["hbm_bytes_per_s"])
    assert k4.search_seconds(n, probes) == pytest.approx(want)


def test_moment_z_reads_a_standard_normal_and_a_shift():
    g = torch.Generator().manual_seed(9)
    circ = torch.tensor([False, True])

    def draws(n, shift=0.0):
        x = torch.randn(n, 2, generator=g, dtype=torch.float64)
        x[:, 0] += shift
        x[:, 1] = torch.remainder(x[:, 1] * 0.5 + math.pi, 2 * math.pi) \
            - math.pi
        return x
    same = [moments.moment_z(draws(20000), draws(20000), circ)
            for _ in range(5)]
    assert max(same) < 4.5
    assert moments.moment_z(draws(20000, 0.1), draws(20000), circ) > 6.0
    # counts weigh as repeated draws
    x = draws(50)
    w = torch.arange(1, 51, dtype=torch.float64)
    rep = x.repeat_interleave(torch.arange(1, 51), 0)
    y = draws(400)
    assert moments.moment_z(x, y, circ, wa=w) == pytest.approx(
        moments.moment_z(rep, y, circ), rel=1e-9)


@pytest.mark.parametrize("n,d", [(37, 2), (50, 3), (64, 1)])
def test_tree_levels_match_the_ports_device_plan(n, d):
    """The reference's copy of the median-split tree gives the port's level
    hierarchy (which the reference never calls)."""
    from kde_tpu_torch import kde
    from kde_tpu_torch.ops.device_plan import DeviceProductPlan
    rng = np.random.default_rng(8 + d)
    pts = torch.tensor(rng.normal(size=(n, d)))
    bw = torch.tensor(rng.uniform(0.1, 0.3, size=d))
    plan = DeviceProductPlan([kde(pts.T, bw)], n, torch.float64)
    levels = msgibbs.tree_levels(pts, bw ** 2, torch.full(
        (n,), -math.log(n), dtype=torch.float64), plan.n_levels)
    for lv, (o, w) in enumerate(plan.offsets, start=1):
        mean, var, logw, leaf = levels[lv]
        assert mean.shape[0] == w
        for got, want in ((mean, plan.lvl_mean[0, o:o + w]),
                          (var, plan.lvl_bw[0, o:o + w]),
                          (logw, plan.lvl_logw[0, o:o + w])):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-9, atol=1e-12)
        is_leaf = leaf >= 0
        assert torch.equal(leaf[is_leaf], plan.lvl_perm[0, o:o + w][is_leaf])


def test_multiscale_gibbs_of_single_kernels_is_their_product():
    circ = torch.tensor([False, True])
    p = (torch.tensor([[0.3, 3.0]], dtype=torch.float64),
         torch.tensor([0.2, 0.1], dtype=torch.float64),
         torch.zeros(1, dtype=torch.float64))
    q = (torch.tensor([[-0.5, -3.0]], dtype=torch.float64),
         torch.tensor([0.6, 0.3], dtype=torch.float64),
         torch.zeros(1, dtype=torch.float64))
    x, lab = msgibbs.sample([p, q], circ, 4, 5, torch.Generator()
                            .manual_seed(0), entropy=False)
    assert torch.equal(lab, torch.zeros(4, 2, dtype=torch.int64))
    # two sets at once draw as each alone
    sets = [[p, q], [q, p]]
    xs, _ = msgibbs.sample_sets(sets, circ, 3, 5, torch.Generator()
                                .manual_seed(0), entropy=False)
    np.testing.assert_allclose(xs[0].numpy(), x[:3].numpy(), rtol=1e-12)
    mean_x = (0.6 * 0.3 + 0.2 * -0.5) / 0.8
    dth = -3.0 - 3.0 + 2 * math.pi          # wrapped: 0.283...
    mean_t = 3.0 + 0.1 / 0.4 * dth
    np.testing.assert_allclose(x[:, 0].numpy(), mean_x, rtol=1e-12)
    np.testing.assert_allclose(x[:, 1].numpy(), mean_t, rtol=1e-12)
    x, _ = msgibbs.sample([p, q], circ, 20000, 5,
                          torch.Generator().manual_seed(1))
    assert float(x[:, 0].var()) == pytest.approx(0.2 * 0.6 / 0.8, rel=0.05)


def test_the_circular_hooks_move_draws_across_the_wrap():
    """Beliefs about an angle near +-pi: the reference with its circular
    hooks dropped (the ``no_hooks`` variant) reads far from the reference."""
    g = torch.Generator().manual_seed(3)
    circ = torch.tensor([False, True])

    def belief(centre):
        mu = torch.randn(300, 2, generator=g, dtype=torch.float64) * 0.05
        mu[:, 1] = torch.remainder(mu[:, 1] + centre + math.pi,
                                   2 * math.pi) - math.pi
        return (mu, torch.tensor([0.01, 0.01], dtype=torch.float64),
                torch.full((300,), -math.log(300), dtype=torch.float64))
    bel = [belief(math.pi - 0.15), belief(-math.pi + 0.15)]
    ref, _ = msgibbs.sample(bel, circ, 3000, 5, g)
    again, _ = msgibbs.sample(bel, circ, 3000, 5, g)
    off, _ = msgibbs.sample_variant("no_hooks", [bel], circ, 3000, 5, g)
    assert moments.moment_z(again, ref, circ) < 4.5
    assert moments.moment_z(off[0], ref, circ) > 20.0


@pytest.mark.parametrize("hooks", ["euclid", "circular"])
def test_the_ports_draws_follow_the_multiscale_reference(hooks):
    """The port's product chains (its CPU twin) and the reference draw from
    one distribution: the draws' moments agree within a standard normal's
    reach, at a size where the exact product's moments do not bound the
    reference's gap."""
    import kde_tpu_torch as kt
    g = torch.Generator().manual_seed(5)
    circ = torch.tensor([False, hooks == "circular"])
    kw = {}
    if hooks == "circular":
        m = kt.manifolds
        kw = dict(addop=(m.euclid_add, m.circular_add),
                  diffop=(m.euclid_diff, m.circular_diff),
                  get_mu=(m.euclid_mu, m.circular_mu),
                  get_lambda=(m.euclid_lambda, m.circular_lambda))
    n = 400
    bel, dens = [], []
    for centre in (2.9, -3.0):
        mu = torch.randn(n, 2, generator=g, dtype=torch.float64) * 0.4
        mu[:, 1] = torch.remainder(mu[:, 1] + centre + math.pi,
                                   2 * math.pi) - math.pi
        bw = torch.tensor([0.15, 0.1], dtype=torch.float64)
        bel.append((mu, bw ** 2, torch.full((n,), -math.log(n),
                                            dtype=torch.float64)))
        dens.append(kt.kde(mu.T, bw))
    x, _ = kt.prod_appx_ms_gibbs(4000, dens, n_iter=5, key=7, **kw)
    ref, _ = msgibbs.sample(bel, circ, 4000, 5, g)
    assert moments.moment_z(x.T, ref, circ) < 4.5
