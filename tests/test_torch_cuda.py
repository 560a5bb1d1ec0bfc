"""Tests that need a CUDA card: the hand-written kernel against its plain
twin, and the port's main path at a small size on the card.  They import
neither JAX nor kde_tpu, so on the GPU machine they run without the JAX
package's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Elsewhere they skip.  The kernel sums in float32 in another order than the
twin, hence rtol = atol = 2e-4 (the tolerance of tests/test_pallas_eval.py);
-inf positions must agree exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want):
    g, r = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isneginf(g), np.isneginf(r))
    fin = np.isfinite(r)
    assert np.isfinite(g[fin]).all()
    np.testing.assert_allclose(g[fin], r[fin], rtol=2e-4, atol=2e-4)


RAGGED = (1, 31, 127, 128, 129, 4097, 20000)
DIMS = (1, 2, 3, 9, 16)       # 9 and 16 take the padded widths 12 and 16


def _kernel_inputs(cuda, m, n, d, loo, seed, zero_weights=0):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(n, d))
    q = mu if loo else rng.normal(size=(m, d))
    var = rng.uniform(0.2, 1.0, size=(n, d))
    w = rng.uniform(0.1, 1.0, size=n)
    w[:zero_weights] = 0.0
    w /= w.sum()
    return [torch.as_tensor(x, dtype=torch.float32, device=cuda)
            for x in (q, mu, var, w)]


def _check_kernel(args, loo):
    from kde_tpu_torch.ops import tiled_eval
    before = tiled_eval.LAUNCHES
    got = tiled_eval.tiled_log_eval(*args, loo=loo)
    torch.cuda.synchronize()
    assert tiled_eval.LAUNCHES == before + 1
    _assert_close(got, tiled_eval.tiled_log_eval_ref(*args, loo=loo))
    return got


@pytest.mark.parametrize("m,n,loo", [(m, n, False) for m in RAGGED
                                     for n in RAGGED]
                         + [(n, n, True) for n in RAGGED])
def test_kernel_matches_ref(cuda, m, n, loo):
    """Every d of DIMS at a ragged (M, N): the launch plan's edges, splits
    and chunk padding against the twin."""
    if m * n > 4097 * 4097:
        dims = (1, 2, 16)     # the twin's time at 20,000 x 20,000
    else:
        dims = DIMS
    for d in dims:
        _check_kernel(_kernel_inputs(cuda, m, n, d, loo, m + n + d), loo)


@pytest.mark.parametrize("d", range(1, 17))
def test_kernel_every_dim(cuda, d):
    """Each compile-time width and each padded dim count (d = 9..12 at
    width 12, 13..16 at 16) against the twin, plain and LOO."""
    _check_kernel(_kernel_inputs(cuda, 129, 4097, d, False, d), False)
    _check_kernel(_kernel_inputs(cuda, 300, 300, d, True, d), True)


@pytest.mark.parametrize("d", [1, 2, 9])
def test_kernel_zero_weights_and_masked_rows(cuda, d):
    """A block of zero-weight components (a whole split of them) adds
    nothing; a LOO row whose only positive-weight component is its own
    diagonal is -inf, as is N = 1 LOO."""
    from kde_tpu_torch.ops import tiled_eval
    n = 4097
    args = _kernel_inputs(cuda, n, n, d, False, d, zero_weights=3000)
    _check_kernel(args, False)
    q, mu, var, w = args
    keep = torch.arange(n, device=cuda) >= 3000
    want = tiled_eval.tiled_log_eval_ref(q, mu[keep].contiguous(),
                                         var[keep].contiguous(),
                                         w[keep].contiguous())
    _assert_close(tiled_eval.tiled_log_eval(q, mu, var, w), want)
    w1 = torch.zeros(n, dtype=torch.float32, device=cuda)
    w1[7] = 1.0
    got = _check_kernel([mu, mu, var, w1], True)
    assert bool(torch.isneginf(got[7])) and bool(torch.isfinite(got[:7]).all())
    one = _check_kernel(_kernel_inputs(cuda, 1, 1, d, True, d), True)
    assert bool(torch.isneginf(one).all())


def test_kernel_offset_data_against_float64(cuda):
    """Centers N(10^3, 1), bandwidth 10^-2, queries beside them: against the
    twin in float64 on the same float32 inputs.  A float32 ulp at 10^3 is
    6.1e-5, so a q*s - mu*s form would lose ~1e-2 of each scaled
    difference; the kernel's q - mu is exact here (Sterbenz), leaving a few
    ulp of the O(10) logits: atol 1e-4, rtol 1e-5."""
    from kde_tpu_torch.ops import tiled_eval
    rng = np.random.default_rng(11)
    n = 4096
    mu = 1e3 + rng.normal(size=(n, 2))
    q = mu[rng.permutation(n)] + 0.01 * rng.normal(size=(n, 2))
    var = np.full((n, 2), 1e-4)
    w = np.full(n, 1.0 / n)
    args = [torch.as_tensor(x, dtype=torch.float32, device=cuda)
            for x in (q, mu, var, w)]
    got = tiled_eval.tiled_log_eval(*args)
    want = tiled_eval.tiled_log_eval_ref(*(a.double() for a in args))
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-4)


def test_numpy_density_lands_on_the_card(cuda, tmp_path):
    """With the package's default device, NumPy, string and file inputs
    put the density on the card."""
    import kde_tpu_torch as kt
    rng = np.random.default_rng(12)
    p = kt.kde(rng.normal(size=(2, 300)), [0.3])
    assert p.device.type == "cuda"
    kt.save_kde(str(tmp_path / "p.npz"), p)
    for k in (kt.from_string(kt.to_string(p)),
              kt.load_kde(str(tmp_path / "p.npz")),
              kt.kde_from_numpy(rng.normal(size=(10, 2)), np.ones((10, 2)),
                                np.full(10, 0.1), False)):
        assert k.device.type == "cuda"


def test_kernel_rejects_float64(cuda):
    from kde_tpu_torch.ops import tiled_eval
    x = torch.zeros(4, 2, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        tiled_eval.tiled_log_eval(x, x, x + 1, x[:, 0] + 0.25)


def test_small_slice_on_card(cuda, monkeypatch):
    """fit -> product -> refit -> evaluate on the card with the gates low,
    so every stage reaches the kernel; the evaluation agrees with the same
    density evaluated on the CPU in float64."""
    import kde_tpu_torch as kt
    from kde_tpu_torch import config
    from kde_tpu_torch.ops import kernels, tiled_eval
    monkeypatch.setattr(config, "DIRECT_PAIR_LIMIT", 1)
    monkeypatch.setattr(config, "LOOCV_PAIR_LIMIT", 1)
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.normal(size=(2, 300)), dtype=torch.float32,
                        device=cuda)
    b = torch.as_tensor(rng.normal(size=(2, 300)) + 0.5,
                        dtype=torch.float32, device=cuda)
    n0 = tiled_eval.LAUNCHES
    p, q = kt.kde(a), kt.kde(b)
    n1 = tiled_eval.LAUNCHES
    pq = kt.product([p, q], key=0)
    n2 = tiled_eval.LAUNCHES
    queries = rng.normal(size=(2, 500))
    lp = pq.log_eval(queries)
    n3 = tiled_eval.LAUNCHES
    assert n1 > n0 and n2 > n1 and n3 == n2 + 1
    assert pq.points.is_cuda and torch.all(pq.bw > 0)
    ref = kernels.log_eval(torch.as_tensor(queries.T), pq.points.cpu().double(),
                           pq.bw.cpu().double(), pq.weights.cpu().double())
    _assert_close(lp, ref)


def _cuda_sets(cuda, rng, b, n, d=2):
    import kde_tpu_torch as kt
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=cuda)
    return [[kt.kde(f32(rng.normal(size=(d, n)) + 0.25 * i), [0.2]),
             kt.kde(f32(rng.normal(size=(d, n)) + 0.25 * i + 0.5), [0.2])]
            for i in range(b)]


@pytest.mark.parametrize("select", ["cdf", "blocked", "gumbel"])
def test_batched_set_equals_standalone_on_card(cuda, select):
    """Set i of a batch against a standalone product keyed by
    split(key, B)[i]: labels equal on at least 99.9% of chains (the CDF
    is accumulated in float64, so the batch shape moves no ties), points
    within 1e-5 where they are."""
    import kde_tpu_torch as kt
    from kde_tpu_torch.utils.random import split
    rng = np.random.default_rng(1)
    b, n, n_out = 3, 3000, 2000
    sets = _cuda_sets(cuda, rng, b, n)
    pts, idx = kt.BatchedProductSampler(sets, n_out=n_out, n_iter=3).sample(
        7, select=select)
    for i, seed in enumerate(split(7, b)):
        p1, i1 = kt.prod_appx_ms_gibbs(n_out, sets[i], n_iter=3, key=seed,
                                       select=select)
        same = (idx[i] == i1).all(dim=0)
        assert int((~same).sum()) <= 1e-3 * n_out
        assert float((pts[i] - p1)[:, same].abs().max()) <= 1e-5


def test_device_plan_build_is_deterministic(cuda):
    """The same sets' plans built twice on the card are bitwise equal (the
    segment sums use no atomics)."""
    from kde_tpu_torch.ops.device_plan import batched_device_plans
    rng = np.random.default_rng(2)
    sets = _cuda_sets(cuda, rng, 3, 5000)
    one = batched_device_plans(sets, 5000, torch.float32)
    two = batched_device_plans(sets, 5000, torch.float32)
    assert one[6:] == two[6:]
    for a, b in zip(one[:6], two[:6]):
        assert a.is_cuda and torch.equal(a, b)


def test_small_product_batched_launches_kernel(cuda, monkeypatch):
    """product_batched on the card with the LOOCV gate at 1: the refit of
    the B x d sample rows launches the kernel, and the products stay on
    the card."""
    import kde_tpu_torch as kt
    from kde_tpu_torch import config
    from kde_tpu_torch.ops import tiled_eval
    monkeypatch.setattr(config, "LOOCV_PAIR_LIMIT", 1)
    rng = np.random.default_rng(3)
    sets = _cuda_sets(cuda, rng, 2, 300)
    before = tiled_eval.LAUNCHES
    outs = kt.product_batched(sets, key=0)
    torch.cuda.synchronize()
    assert tiled_eval.LAUNCHES > before
    for i, k in enumerate(outs):
        assert k.points.is_cuda and k._tree is None and torch.all(k.bw > 0)
        mean = k.points.double().mean(dim=0).cpu().numpy()
        assert np.all(np.abs(mean - (0.25 * i + 0.25)) < 0.25)


def test_small_hooked_product_on_card(cuda, monkeypatch):
    """A circular `*` on the card with both gates at 1: the refit launches
    the kernel, the hooked evaluation does not (the kernel computes a
    Euclidean difference) and matches float64 on the CPU."""
    import math
    import kde_tpu_torch as kt
    from kde_tpu_torch import config, manifolds as m
    from kde_tpu_torch.ops import kernels, tiled_eval
    monkeypatch.setattr(config, "DIRECT_PAIR_LIMIT", 1)
    monkeypatch.setattr(config, "LOOCV_PAIR_LIMIT", 1)
    circ = dict(addop=(m.circular_add,), diffop=(m.circular_diff,),
                get_mu=(m.circular_mu,), get_lambda=(m.circular_lambda,))
    rng = np.random.default_rng(4)
    wrap = lambda a: a - 2 * np.pi * np.round(a / (2 * np.pi))
    dens = [kt.kde(torch.as_tensor(wrap(s + 0.05 * rng.normal(size=(1, 400))),
                                   dtype=torch.float32, device=cuda),
                   [0.1], **circ)
            for s in (math.pi - 0.2, -math.pi + 0.2)]
    n0 = tiled_eval.LAUNCHES
    pq = kt.product(dens, key=0)
    n1 = tiled_eval.LAUNCHES
    q = wrap(math.pi + 0.3 * rng.normal(size=(1, 300)))
    lp = pq.log_eval(q)
    torch.cuda.synchronize()
    assert n1 > n0 and tiled_eval.LAUNCHES == n1
    assert pq.points.is_cuda and pq.get_mu[0] is m.circular_mu
    x = pq.points[:, 0].cpu().numpy()
    assert np.median(np.abs(wrap(x - np.pi))) < 0.5
    ref = kernels.log_eval(torch.as_tensor(q.T), pq.points.cpu().double(),
                           pq.bw.cpu().double(), pq.weights.cpu().double(),
                           pq._eval_diffop)
    _assert_close(lp, ref)


def test_small_functionals_on_card(cuda, monkeypatch, tmp_path):
    """entropy on the kernel (gates at 1) against the same call on the
    plain twin; the densities that resample, ksize, kld("unscented"),
    from_string and load_kde build from a card density stay on the card."""
    import kde_tpu_torch as kt
    from kde_tpu_torch import config
    from kde_tpu_torch.ops import kernels, tiled_eval
    monkeypatch.setattr(config, "DIRECT_PAIR_LIMIT", 1)
    monkeypatch.setattr(config, "LOOCV_PAIR_LIMIT", 1)
    rng = np.random.default_rng(5)
    p = kt.kde(torch.as_tensor(rng.normal(size=(2, 500)), dtype=torch.float32,
                               device=cuda))
    q = kt.kde(torch.as_tensor(rng.normal(size=(2, 400)) + 0.5,
                               dtype=torch.float32, device=cuda))
    before = tiled_eval.LAUNCHES
    h = kt.entropy(p)
    torch.cuda.synchronize()
    assert tiled_eval.LAUNCHES == before + 1
    launch = kernels.tiled_log_eval
    monkeypatch.setattr(kernels, "tiled_log_eval",
                        tiled_eval.tiled_log_eval_ref)
    _assert_close(h.reshape(1), kt.entropy(p).reshape(1))
    monkeypatch.setattr(kernels, "tiled_log_eval", launch)
    before = tiled_eval.LAUNCHES
    u = kt.kld(p, q, "unscented")
    assert tiled_eval.LAUNCHES > before and bool(torch.isfinite(u))
    kt.save_kde(str(tmp_path / "p.npz"), p)
    made = [kt.resample(p, 300, "lcv", key=1),
            kt.resample(p, 300, "discrete", key=1), kt.ksize(p),
            kt.from_string(kt.to_string(p), device=cuda),
            kt.load_kde(str(tmp_path / "p.npz"), device=cuda)]
    for k in made:
        assert k.points.device.type == "cuda" and k.device.type == "cuda"
    assert torch.equal(made[4].points, p.points)
    assert torch.equal(made[3].points, p.points)


def _one_rank_world(backend):
    """A one-rank world of ``backend`` on a free TCP port, left at
    teardown."""
    import socket
    import torch.distributed as dist
    from kde_tpu_torch.parallel import initialize_multihost
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_multihost(f"127.0.0.1:{port}", 1, 0, backend=backend,
                         timeout=120)
    yield
    dist.destroy_process_group()


@pytest.fixture
def nccl_world(cuda):
    yield from _one_rank_world("nccl")


@pytest.fixture
def gloo_world(cuda):
    yield from _one_rank_world("gloo")


def test_single_rank_nccl_sharded(nccl_world, cuda, monkeypatch):
    """product_sharded and sharded_log_eval through NCCL with both gates at
    1: the refit and the evaluation launch the kernel, the product stays
    on the card and equals `*` of the same key, and the evaluation agrees
    with float64 on the CPU."""
    import kde_tpu_torch as kt
    from kde_tpu_torch import config, parallel as par
    from kde_tpu_torch.ops import kernels, tiled_eval
    monkeypatch.setattr(config, "DIRECT_PAIR_LIMIT", 1)
    monkeypatch.setattr(config, "LOOCV_PAIR_LIMIT", 1)
    rng = np.random.default_rng(6)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=cuda)
    dens = [kt.kde(f32(rng.normal(size=(2, 300)) + s)) for s in (0.0, 0.5)]
    mesh = par.make_mesh()
    n0 = tiled_eval.LAUNCHES
    pq = par.product_sharded(mesh, dens, key=0)
    n1 = tiled_eval.LAUNCHES
    assert n1 > n0 and pq.points.is_cuda and pq._tree is None
    want = kt.product(dens, key=0)
    torch.testing.assert_close(pq.points, want.points, rtol=0, atol=1e-6)
    q = f32(rng.normal(size=(500, 2)))
    n2 = tiled_eval.LAUNCHES
    lp = par.sharded_log_eval(par.make_mesh_2d((1, 1)), q, pq.points, pq.bw,
                              pq.weights)
    torch.cuda.synchronize()
    assert tiled_eval.LAUNCHES == n2 + 1 and lp.is_cuda
    ref = kernels.log_eval(q.cpu().double(), pq.points.cpu().double(),
                           pq.bw.cpu().double(), pq.weights.cpu().double())
    _assert_close(lp, ref)


def test_gloo_sharded_eval_stays_on_card(gloo_world, cuda, monkeypatch):
    """A gloo mesh over CUDA inputs keeps the sharded evaluation and LOOCV
    on the card: sharded_log_eval launches the kernel, and all three
    return CUDA tensors that agree with the single-device calls."""
    from kde_tpu_torch import config, parallel as par
    from kde_tpu_torch.ops import kernels, loocv, tiled_eval
    monkeypatch.setattr(config, "DIRECT_PAIR_LIMIT", 1)
    rng = np.random.default_rng(7)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=cuda)
    pts = f32(rng.normal(size=(300, 2)))
    var = f32(rng.uniform(0.05, 0.2, size=(300, 2)))
    w = f32(np.full(300, 1.0 / 300))
    q = f32(rng.normal(size=(500, 2)))
    mesh = par.make_mesh_2d((1, 1))
    n0 = tiled_eval.LAUNCHES
    lp = par.sharded_log_eval(mesh, q, pts, var, w)
    torch.cuda.synchronize()
    assert tiled_eval.LAUNCHES == n0 + 1 and lp.is_cuda
    h = par.sharded_loo_entropy(mesh, pts, var, w)
    bws = par.ksize_bandwidths_sharded(mesh, pts)
    assert h.is_cuda and bws.is_cuda
    _assert_close(lp, kernels.log_eval(q.cpu().double(), pts.cpu().double(),
                                       var.cpu().double(),
                                       w.cpu().double()))
    torch.testing.assert_close(h, kernels.entropy_kernel(pts, var, w),
                               rtol=2e-4, atol=0)
    torch.testing.assert_close(bws, loocv.ksize_bandwidths_device(pts),
                               rtol=1e-5, atol=0)


# ---- the float64 small routes (ops/host_small.py, csrc/small_ops.cu) -------

def _cfg1_points(seed=0):
    """README cfg 1: 50 + 50 bimodal points in 1-D."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(size=50),
                           10.0 + 2.0 * rng.normal(size=50)])


def _golden_rows(name):
    rng = np.random.default_rng(11)
    if name == "cfg1":
        rows = _cfg1_points()[None, :]
    elif name == "d2":
        rows = (rng.normal(size=(120, 2)) * [1.0, 2.5]).T
    elif name == "gate_edge":
        rows = rng.normal(size=(1, 255))
    elif name == "zero_weights":             # tests/test_host_small.py:143
        x = np.concatenate([rng.normal(size=95) * 0.01, [500.0]])
        rows = np.concatenate([x, x + 1e-6])[None, :]
        w = np.concatenate([np.full(96, 1.0 / 96), np.zeros(96)])
        return rows, w
    else:                                    # "n1", "n2"
        rows = rng.normal(size=(1, int(name[1:])))
    return rows, np.full(rows.shape[1], 1.0 / rows.shape[1])


@pytest.mark.parametrize("name", ["cfg1", "d2", "gate_edge", "zero_weights",
                                  "n1", "n2"])
def test_loo_golden_matches_twin_on_card(cuda, name):
    """One launch of loo_golden for all rows against the twin's scalar
    searches on the CPU: the same selection to rtol 1e-9."""
    from kde_tpu_torch.ops import host_small
    rows, w = (torch.as_tensor(np.ascontiguousarray(a))
               for a in _golden_rows(name))
    before = host_small.LAUNCHES["loo_golden"]
    got = host_small.ksize_small(rows.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert host_small.LAUNCHES["loo_golden"] == before + 1
    assert got.is_cuda and got.dtype == torch.float64
    np.testing.assert_allclose(got.cpu().numpy(),
                               host_small.ksize_small_ref(rows, w).numpy(),
                               rtol=1e-9)


def _eval_inputs(name):
    rng = np.random.default_rng(3)
    if name == "cfg1":
        x = _cfg1_points(1)
        mu = x[:, None]
        q = np.linspace(x.min(), x.max(), 200)[:, None]
        var = np.full_like(mu, 0.36)
    elif name == "widest":
        mu, q = rng.normal(size=(300, 4)), 1.5 * rng.normal(size=(200, 4))
        var = rng.uniform(0.05, 0.5, size=(300, 4))
    else:                                    # "exp_wrap", test_host_small:207
        mu = (np.arange(9) * 1e-6)[:, None]
        var = np.full((9, 1), 0.5)
        q = np.sqrt(np.concatenate([np.linspace(705.0, 715.0, 401),
                                    np.linspace(2125.0, 2135.0, 401)]))[:, None]
    w = rng.uniform(0.5, 1.5, size=len(mu))
    if name == "widest":
        w[::7] = 0.0                         # zero weights: -inf logits
    return [torch.as_tensor(np.ascontiguousarray(a))
            for a in (q, mu, var, w / w.sum())]


@pytest.mark.parametrize("name,loo", [("cfg1", False), ("widest", False),
                                      ("exp_wrap", False), ("cfg1", True),
                                      ("widest", True)])
def test_small_log_eval_matches_twin_on_card(cuda, name, loo):
    from kde_tpu_torch.ops import host_small
    q, mu, var, w = _eval_inputs(name)
    before = host_small.LAUNCHES["small_log_eval"]
    if loo:
        got = host_small.log_eval_loo_small(mu.to(cuda), var.to(cuda),
                                            w.to(cuda))
        want = host_small.log_eval_loo_small(mu, var, w)
    else:
        got = host_small.log_eval_small(q.to(cuda), mu.to(cuda), var.to(cuda),
                                        w.to(cuda))
        want = host_small.log_eval_small(q, mu, var, w)
    torch.cuda.synchronize()
    assert host_small.LAUNCHES["small_log_eval"] == before + 1
    assert got.is_cuda and got.dtype == torch.float64
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-10)


def test_small_routes_of_readme_cfg1_on_card(cuda):
    """kde, p(grid), the LOO evaluation and resample("lcv") of README cfg 1
    with the package's defaults: float64 results on the card, both kernels
    launched, values equal to the same flow on the CPU."""
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import host_small
    x = _cfg1_points(2)
    grid = np.linspace(x.min(), x.max(), 200)
    before = dict(host_small.LAUNCHES)
    p = kt.kde(x[None, :])
    v = p(grid)
    lv = p.evaluate(None, lv_flag=True)
    r = kt.resample(p, 75, "lcv", key=3)
    torch.cuda.synchronize()
    assert p.device.type == "cuda" and r.device.type == "cuda"
    assert v.is_cuda and v.dtype == torch.float64 and lv.dtype == torch.float64
    assert host_small.LAUNCHES["loo_golden"] >= before["loo_golden"] + 2
    assert host_small.LAUNCHES["small_log_eval"] >= before["small_log_eval"] + 2
    c = kt.kde(x[None, :], device="cpu")
    np.testing.assert_allclose(p.host_bw_std(), c.host_bw_std(), rtol=1e-9)
    torch.testing.assert_close(v.cpu(), c(grid), rtol=1e-12, atol=0)
    torch.testing.assert_close(lv.cpu(), c.evaluate(None, lv_flag=True),
                               rtol=1e-12, atol=0)


def test_loo_golden_above_its_row_limit_raises(cuda):
    """A row longer than the kernel's shared memory holds raises on the
    card instead of launching, and is not counted."""
    from kde_tpu_torch.ops import host_small
    n = host_small.GOLDEN_MAX_N + 1
    f64 = dict(dtype=torch.float64, device=cuda)
    before = dict(host_small.LAUNCHES)
    with pytest.raises(ValueError, match="GOLDEN_MAX_N|N <="):
        host_small.ksize_small(torch.arange(float(n), **f64)[None],
                               torch.full((n,), 1.0 / n, **f64))
    assert host_small.LAUNCHES == before


def test_small_ops_without_a_build_raise(cuda, monkeypatch):
    """CUDA tensors launch the kernels or raise: with a build that fails,
    neither wrapper falls back to its twin, and nothing is counted."""
    from kde_tpu_torch.ops import host_small
    monkeypatch.setattr(host_small, "_lib", None)
    monkeypatch.setattr(host_small, "NVCC_FLAGS",
                        [*host_small.NVCC_FLAGS, "--no-such-flag"])
    f64 = dict(dtype=torch.float64, device=cuda)
    x = torch.zeros(4, 1, **f64)
    w = torch.full((4,), 0.25, **f64)
    before = dict(host_small.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        host_small.log_eval_small(x, x, torch.ones_like(x), w)
    with pytest.raises(RuntimeError, match="nvcc"):
        host_small.ksize_small(torch.arange(4.0, **f64)[None], w)
    assert host_small.LAUNCHES == before
