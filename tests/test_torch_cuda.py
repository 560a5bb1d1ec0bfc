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


def _check_kernel(args, loo, diag=0):
    from kde_tpu_torch.ops import tiled_eval
    before = tiled_eval.LAUNCHES
    got = tiled_eval.tiled_log_eval(*args, loo=loo, diag=diag)
    torch.cuda.synchronize()
    assert tiled_eval.LAUNCHES == before + 1
    _assert_close(got, tiled_eval.tiled_log_eval_ref(*args, loo=loo,
                                                     diag=diag))
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


# ---- K1's LOO mask at a diagonal offset: query m skips component m + diag --

DIAG_SHAPES = [(300, 700, 2), (700, 300, 3), (257, 257, 1),
               (4097, 8192, 2), (10000, 20000, 2), (2000, 4097, 9)]
DIAG_NAMES = ("0", "+1", "-1", "+block", "-block", "split", "last_col",
              "first_col", "past_n", "past_m")


def _diag(name, m, n, d, sms):
    """0, +-1, +- one query block of the chosen plan, query block 0's
    skipped columns across its first split boundary (entering a chunk
    part-way), a column for the first row only (n - 1) and the last row
    only (1 - m), and past either end (nothing skipped)."""
    from kde_tpu_torch.ops import tiled_eval
    plan = tiled_eval.launch_plan(m, n, d, sms)
    block = plan.threads * plan.rows_per_thread
    return {"0": 0, "+1": 1, "-1": -1, "+block": block, "-block": -block,
            "split": plan.per_split - block // 2 - 3, "last_col": n - 1,
            "first_col": 1 - m, "past_n": max(m, n) + 5,
            "past_m": -max(m, n) - 5}[name]


def _diag_inputs(cuda, m, n, d, diag, seed):
    """Query i sits on the component it skips (mean i + diag, where that
    is a column), so a missed or misplaced mask fails the tolerance."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(n, d))
    q = rng.normal(size=(m, d))
    i = np.arange(m)
    on = (i + diag >= 0) & (i + diag < n)
    q[on] = mu[i[on] + diag]
    var = rng.uniform(0.005, 0.05, size=(n, d))
    w = rng.uniform(0.1, 1.0, size=n)
    return [torch.as_tensor(x, dtype=torch.float32, device=cuda)
            for x in (q, mu, var, w / w.sum())]


def _sms(cuda):
    return torch.cuda.get_device_properties(cuda).multi_processor_count


@pytest.mark.parametrize("name", DIAG_NAMES)
@pytest.mark.parametrize("m,n,d", DIAG_SHAPES)
def test_kernel_diag_matches_twin_every_plan(cuda, m, n, d, name):
    """K1 with an offset against its twin: the chosen plan (one counted
    launch) and every plan of the shape (launch_with_plan, uncounted)."""
    from kde_tpu_torch.ops import tiled_eval
    sms = _sms(cuda)
    diag = _diag(name, m, n, d, sms)
    args = _diag_inputs(cuda, m, n, d, diag, m + n + d)
    want = tiled_eval.tiled_log_eval_ref(*args, loo=True, diag=diag)
    _check_kernel(args, True, diag)
    before = tiled_eval.LAUNCHES
    for _, plan in tiled_eval.plans(m, n, d, sms):
        _assert_close(tiled_eval.launch_with_plan(*args, True, plan, diag),
                      want)
    assert tiled_eval.LAUNCHES == before


@pytest.mark.parametrize("m,n,d", DIAG_SHAPES)
def test_kernel_diag_zero_and_past_the_ends_bitwise(cuda, m, n, d):
    """On every plan: diag = 0 is bitwise the LOO launch without an
    offset, and an offset past either end (even one beyond a C int)
    bitwise the launch without LOO."""
    from kde_tpu_torch.ops import tiled_eval
    args = _diag_inputs(cuda, m, n, d, 0, 7 * m + d)
    for _, plan in tiled_eval.plans(m, n, d, _sms(cuda)):
        loo = tiled_eval.launch_with_plan(*args, True, plan)
        assert torch.equal(tiled_eval.launch_with_plan(*args, True, plan, 0),
                           loo)
        plain = tiled_eval.launch_with_plan(*args, False, plan)
        for diag in (n, n + 1, -m, -m - 7, 1 << 40, -(1 << 40)):
            assert torch.equal(
                tiled_eval.launch_with_plan(*args, True, plan, diag), plain)


def test_kernel_diag_fully_masked_rows(cuda):
    """One positive-weight component k: the row k - diag is -inf, the
    others finite; a one-column call skips its column in one row only."""
    from kde_tpu_torch.ops import tiled_eval
    m, n, d = 700, 300, 3
    for name in ("+1", "-block", "split", "first_col"):
        diag = _diag(name, m, n, d, _sms(cuda))
        row = min(max(m // 2, -diag), n - 1 - diag, m - 1)
        q, mu, var, _ = _diag_inputs(cuda, m, n, d, diag, 3)
        w = torch.zeros(n, dtype=torch.float32, device=cuda)
        w[row + diag] = 1.0
        got = _check_kernel([q, mu, var, w], True, diag)
        dead = torch.zeros(m, dtype=torch.bool, device=cuda)
        dead[row] = True
        assert torch.equal(torch.isneginf(got), dead)
    q, mu, var, w = _diag_inputs(cuda, 50, 1, 2, -20, 4)
    got = _check_kernel([q, mu, var, w], True, -20)
    assert torch.isneginf(got).nonzero().flatten().tolist() == [20]


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
    """fit -> product -> refit -> evaluate on the card with the gates low:
    each fit and the refit is one launch of the LOOCV search kernel (K4),
    the evaluation one of the evaluation kernel (K1), and it agrees with
    the same density evaluated on the CPU in float64."""
    import kde_tpu_torch as kt
    from kde_tpu_torch import config
    from kde_tpu_torch.ops import kernels, loo_search, tiled_eval
    monkeypatch.setattr(config, "DIRECT_PAIR_LIMIT", 1)
    monkeypatch.setattr(config, "LOOCV_PAIR_LIMIT", 1)
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.normal(size=(2, 300)), dtype=torch.float32,
                        device=cuda)
    b = torch.as_tensor(rng.normal(size=(2, 300)) + 0.5,
                        dtype=torch.float32, device=cuda)
    n0, k0 = tiled_eval.LAUNCHES, loo_search.LAUNCHES
    p, q = kt.kde(a), kt.kde(b)
    n1, k1 = tiled_eval.LAUNCHES, loo_search.LAUNCHES
    pq = kt.product([p, q], key=0)
    n2, k2 = tiled_eval.LAUNCHES, loo_search.LAUNCHES
    queries = rng.normal(size=(2, 500))
    lp = pq.log_eval(queries)
    n3 = tiled_eval.LAUNCHES
    assert k1 == k0 + 2 and k2 == k1 + 1 and loo_search.LAUNCHES == k2
    assert n1 == n0 and n2 == n1 and n3 == n2 + 1
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
    assert one[6:8] == two[6:8]
    assert torch.equal(one[8], two[8])
    for a, b in zip(one[:6], two[:6]):
        assert a.is_cuda and torch.equal(a, b)


def test_small_product_batched_launches_kernel(cuda, monkeypatch):
    """product_batched on the card with the LOOCV gate at 1: the refit of
    the B x d sample rows is one launch of the LOOCV search kernel (K4,
    which takes every size), and the products stay on the card."""
    import kde_tpu_torch as kt
    from kde_tpu_torch import config
    from kde_tpu_torch.ops import loo_search
    monkeypatch.setattr(config, "LOOCV_PAIR_LIMIT", 1)
    rng = np.random.default_rng(3)
    sets = _cuda_sets(cuda, rng, 2, 300)
    before = loo_search.LAUNCHES
    outs = kt.product_batched(sets, key=0)
    torch.cuda.synchronize()
    assert loo_search.LAUNCHES == before + 1
    for i, k in enumerate(outs):
        assert k.points.is_cuda and k._tree is None and torch.all(k.bw > 0)
        mean = k.points.double().mean(dim=0).cpu().numpy()
        assert np.all(np.abs(mean - (0.25 * i + 0.25)) < 0.25)


def test_small_hooked_product_on_card(cuda, monkeypatch):
    """A circular `*` on the card with both gates at 1: the refit is one
    launch of the LOOCV search kernel (K4), the hooked evaluation launches
    the evaluation kernel (K1) zero times (it computes a Euclidean
    difference) and matches float64 on the CPU."""
    import math
    import kde_tpu_torch as kt
    from kde_tpu_torch import config, manifolds as m
    from kde_tpu_torch.ops import kernels, loo_search, tiled_eval
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
    n0, k0 = tiled_eval.LAUNCHES, loo_search.LAUNCHES
    pq = kt.product(dens, key=0)
    n1 = tiled_eval.LAUNCHES
    assert loo_search.LAUNCHES == k0 + 1
    q = wrap(math.pi + 0.3 * rng.normal(size=(1, 300)))
    lp = pq.log_eval(q)
    torch.cuda.synchronize()
    assert n1 == n0 and tiled_eval.LAUNCHES == n1
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
    1: the refit launches the LOOCV search kernel (K4) and the evaluation
    the evaluation kernel (K1), the product stays on the card and equals
    `*` of the same key, and the evaluation agrees with float64 on the
    CPU."""
    import kde_tpu_torch as kt
    from kde_tpu_torch import config, parallel as par
    from kde_tpu_torch.ops import kernels, loo_search, tiled_eval
    monkeypatch.setattr(config, "DIRECT_PAIR_LIMIT", 1)
    monkeypatch.setattr(config, "LOOCV_PAIR_LIMIT", 1)
    rng = np.random.default_rng(6)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=cuda)
    dens = [kt.kde(f32(rng.normal(size=(2, 300)) + s)) for s in (0.0, 0.5)]
    mesh = par.make_mesh()
    k0 = loo_search.LAUNCHES
    pq = par.product_sharded(mesh, dens, key=0)
    assert loo_search.LAUNCHES > k0
    assert pq.points.is_cuda and pq._tree is None
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
    return CUDA tensors that agree with the single-device calls (the
    bandwidths with the single-device search on the same eager probes,
    K4's twin)."""
    from kde_tpu_torch import config, parallel as par
    from kde_tpu_torch.ops import kernels, loo_search, loocv, tiled_eval
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
    monkeypatch.setattr(loocv, "loo_search", loo_search.loo_search_ref)
    torch.testing.assert_close(bws, loocv.ksize_bandwidths_device(pts),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("n", [20000, 300])
def test_sharded_loo_entropy_on_k1(nccl_world, cuda, monkeypatch, n):
    """sharded_loo_entropy of float32 CUDA points on the (1, 1) mesh above
    the gate (20,000 points; 300 with the gate at 1) is one K1 launch and
    never the twin or a dense block of logits, holds no [N, N] block (the
    allocator's peak under 16 MB above its inputs), and agrees with
    entropy_kernel (K1)."""
    from kde_tpu_torch import config, parallel as par
    from kde_tpu_torch.ops import kernels, tiled_eval
    if n < 1000:
        monkeypatch.setattr(config, "DIRECT_PAIR_LIMIT", 1)
    rng = np.random.default_rng(n)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=cuda)
    pts = f32(rng.normal(size=(n, 2)))
    var = f32(np.full((n, 2), (1.06 * n ** -0.2) ** 2))
    w = f32(np.full(n, 1.0 / n))
    mesh = par.make_mesh_2d((1, 1))
    par.sharded_loo_entropy(mesh, pts, var, w)          # NCCL's first call

    def refused(*a, **kw):
        raise AssertionError("the twin or dense logits on CUDA tensors")
    monkeypatch.setattr(tiled_eval, "tiled_log_eval_ref", refused)
    monkeypatch.setattr(kernels, "log_gauss_mixture", refused)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    before = tiled_eval.LAUNCHES
    h = par.sharded_loo_entropy(mesh, pts, var, w)
    torch.cuda.synchronize()
    assert tiled_eval.LAUNCHES == before + 1 and h.is_cuda
    assert torch.cuda.max_memory_allocated(cuda) - base < 16 << 20
    torch.testing.assert_close(h, kernels.entropy_kernel(pts, var, w),
                               rtol=2e-4, atol=0)


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


GOLDEN_CASES = ("cfg1", "d2", "gate_edge", "zero_weights", "n1", "n2")
CLUSTERS = (1, 2, 4, 8, 16)


def _admitted(host_small, n, cluster):
    """Whether the card holds a cluster of ``cluster`` search blocks for
    rows of ``n`` points (16 needs the non-portable size)."""
    try:
        return host_small.max_clusters(n, cluster,
                                       torch.cuda.current_device()) > 0
    except RuntimeError:
        return False


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("name", GOLDEN_CASES)
def test_ksize_small_every_cluster_matches_twin(cuda, name, cluster):
    """The fused selection at a forced cluster size against the twin to
    rtol 1e-9, bitwise the same over 10 launches; the search alone from
    the twin's bracket, on the same kernel, too."""
    from kde_tpu_torch.ops import host_small
    rows, w = (torch.as_tensor(np.ascontiguousarray(a))
               for a in _golden_rows(name))
    if not _admitted(host_small, rows.shape[1], cluster):
        pytest.skip(f"the card admits no cluster of {cluster} blocks")
    want = host_small.ksize_small_ref(rows, w).numpy()
    rc, wc = rows.to(cuda), w.to(cuda)
    got = [host_small.ksize_small(rc, wc, cluster=cluster) for _ in range(10)]
    torch.cuda.synchronize()
    for g in got[1:]:
        assert torch.equal(g, got[0])
    np.testing.assert_allclose(got[0].cpu().numpy(), want, rtol=1e-9)
    base, ax, bx, cx = host_small._bracket(rc)
    xmin = host_small.loo_golden(rc, wc, base ** 2, ax, bx, cx, 1e-2,
                                 cluster=cluster)
    np.testing.assert_allclose((xmin * base).cpu().numpy(), want, rtol=1e-9)


def test_ksize_small_is_one_launch(cuda, monkeypatch):
    """On the card the bracket runs in the kernel: one launch a call, no
    torch bracket, and no ATen op but the output's empty."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from kde_tpu_torch.ops import host_small, loocv

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    def no_bracket(*a, **k):
        raise AssertionError("the torch bracket ran on the card's path")
    monkeypatch.setattr(loocv, "bracket_rows", no_bracket)
    rows, w = (torch.as_tensor(np.ascontiguousarray(a), device=cuda)
               for a in _golden_rows("d2"))
    host_small.ksize_small(rows, w)          # the node table, the plan
    torch.cuda.synchronize()
    before = host_small.LAUNCHES["loo_golden"]
    with Ops() as seen:
        out = host_small.ksize_small(rows, w)
    torch.cuda.synchronize()
    assert host_small.LAUNCHES["loo_golden"] == before + 1
    assert seen.ops == ["aten.empty.memory_format"]
    assert out.shape == (2,) and bool(torch.isfinite(out).all())


def test_refused_cluster_size_raises(cuda):
    """A cluster the card does not admit (32 blocks) is refused by the
    launch and raises; nothing falls back and nothing is counted, and the
    next call runs."""
    from kde_tpu_torch.ops import host_small
    rows, w = (torch.as_tensor(np.ascontiguousarray(a), device=cuda)
               for a in _golden_rows("cfg1"))
    before = dict(host_small.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error"):
        host_small.ksize_small(rows, w, cluster=32)
    with pytest.raises(ValueError, match="cluster"):
        host_small.ksize_small(rows, w, cluster=0)
    assert host_small.LAUNCHES == before
    ok = host_small.ksize_small(rows, w, cluster=1)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ok).all())


@pytest.mark.parametrize("name", ["cfg1", "widest", "loo100", "loo255",
                                  "exp_wrap"])
def test_small_log_eval_at_phase_3b_shapes(cuda, name):
    """chip_smoke.py phase 3b's five evaluation shapes (200 x 100 x 1,
    200 x 300 x 4, LOO at N = 100 and 255 in 1-D, the exp-wrap queries):
    the kernel within 1e-10 of its twin."""
    from kde_tpu_torch.ops import host_small
    loo = name.startswith("loo")
    if loo:
        rng = np.random.default_rng(12)
        n = int(name[3:])
        mu = torch.as_tensor(rng.normal(size=(n, 1)))
        var = torch.full((n, 1), 0.1, dtype=torch.float64)
        w = torch.as_tensor(rng.uniform(0.5, 1.5, n))
        q, w = mu, w / w.sum()
    else:
        q, mu, var, w = _eval_inputs(name)
    args = [t.to(cuda) for t in (q, mu, var, w)]
    got = (host_small.log_eval_loo_small(*args[1:]) if loo
           else host_small.log_eval_small(*args))
    torch.cuda.synchronize()
    want = host_small.small_log_eval_ref(q, mu, var, w, loo)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-10)


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


# ---- the Gibbs selection kernel (csrc/gibbs_select.cu) ---------------------

K2_CASES = {
    # name: (b, c, dn, w, d, js, dtype, cov, codes, mode, extras)
    "sweep cdf": (1, 2000, 2, 3000, 2, (0,), "f32", True, (0, 0), "cdf", {}),
    "cond cdf": (1, 2000, 2, 3000, 2, (0, 1), "f32", False, (0, 0), "cdf",
                 {}),
    "f64 cdf": (1, 256, 2, 2000, 2, (0, 1), "f64", True, (0, 0), "cdf", {}),
    "circular cdf": (1, 1000, 2, 3000, 1, (1,), "f32", True, (1,), "cdf", {}),
    "se2 cdf": (1, 1000, 2, 3000, 3, (0, 1), "f32", False, (0, 0, 1), "cdf",
                {}),
    "pad dead cdf": (2, 300, 2, 700, 2, (0, 1), "f32", True, (0, 0), "cdf",
                     dict(pad=29, dead=4, mixed=True)),
    "w 1024 cdf": (1, 300, 2, 1024, 2, (1,), "f64", True, (0, 0), "cdf", {}),
    "w 1025 cdf": (1, 300, 2, 1025, 2, (1,), "f32", True, (0, 0), "cdf", {}),
    "f32 cache edge": (1, 32, 2, 51195, 2, (0, 1), "f32", False, (0, 0),
                       "cdf", {}),
    "f32 past cache": (1, 32, 2, 51196, 2, (0, 1), "f32", False, (0, 0),
                       "cdf", {}),
    "f64 past cache": (1, 32, 2, 25596, 2, (0,), "f64", True, (0, 0), "cdf",
                       {}),
}
K2_CASES.update({k.replace("cdf", "gumbel"): v[:9] + ("gumbel", v[10])
                 for k, v in list(K2_CASES.items())})


def _k2_case(name, cuda, seed):
    import chip_smoke as cs
    b, c, dn, w, d, js, dt, cov, codes, mode, ex = K2_CASES[name]
    dtype = torch.float32 if dt == "f32" else torch.float64
    return cs.k2_inputs(seed, cuda, b, c, dn, w, d, js, dtype, cov, codes,
                        mode, **ex)


@pytest.mark.parametrize("name", sorted(K2_CASES))
def test_gibbs_select_matches_twin(cuda, name):
    """The kernel against its twin (chip_smoke.py phase 3d's check): gumbel
    labels equal on every row, cdf labels on every row but float64 CDF
    ties within 1e-12 of u, each listed; the gathered mean and variance
    equal at equal labels; one launch counted."""
    import chip_smoke as cs
    from kde_tpu_torch.ops import gibbs_select
    args, codes, kw = _k2_case(name, cuda, sorted(K2_CASES).index(name))
    before = gibbs_select.LAUNCHES
    row, labels = cs.k2_compare(args, codes, kw, name)
    assert gibbs_select.LAUNCHES == before + 1
    assert row["max_abs_err"] == 0.0
    if kw["u"] is None:
        assert row["label_mismatches"] == 0
    assert all(t <= 1e-12 for t in row["cdf_ties"])


@pytest.mark.parametrize("d", range(1, 9))
@pytest.mark.parametrize("mode", ["cdf", "gumbel"])
def test_gibbs_select_every_dim(cuda, d, mode):
    """Every d the package takes runs on the kernel (d is a runtime bound):
    1..8 at a small width, mixed active dims."""
    import chip_smoke as cs
    args, codes, kw = cs.k2_inputs(40 + d, cuda, 2, 256, 2, 64, d, (0, 1),
                                   torch.float32, d % 2 == 0, (0,) * d, mode,
                                   mixed=d > 1)
    row, _ = cs.k2_compare(args, codes, kw, f"d={d}")
    assert row["max_abs_err"] == 0.0


def test_gibbs_select_replay_product_equals_twin_route(cuda, monkeypatch):
    """Float64 replay streams through a whole prod_appx_ms_gibbs on the
    stage route: the kernel route equals the same call with every
    selection on the twin (the same chain blocks), labels and points."""
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import balltree, gibbs, gibbs_select
    route = gibbs._route
    monkeypatch.setattr(gibbs, "_route", lambda *a: (
        "kernel" if route(*a) == "chain" else route(*a)))
    rng = np.random.default_rng(21)
    f64 = dict(dtype=torch.float64, device=cuda)
    dens = [kt.kde(torch.as_tensor(rng.normal(size=(2, 500)) + s, **f64),
                   [0.2]) for s in (0.0, 0.5)]
    n_out, n_iter = 400, 3
    L = balltree.n_levels(n_out, [500, 500])
    bu, bn = gibbs._stream_sizes(2, 2, L, n_iter)
    ru, rn = rng.uniform(size=n_out * bu), rng.normal(size=n_out * bn)
    before = gibbs_select.LAUNCHES
    got = kt.prod_appx_ms_gibbs(n_out, dens, n_iter=n_iter, rand_u=ru,
                                rand_n=rn, record_labels=True)
    assert gibbs_select.LAUNCHES == before + L * (1 + n_iter * 2)
    saved = gibbs_select.gibbs_select
    gibbs_select.gibbs_select = gibbs_select.gibbs_select_ref
    try:
        want = kt.prod_appx_ms_gibbs(n_out, dens, n_iter=n_iter, rand_u=ru,
                                     rand_n=rn, record_labels=True)
    finally:
        gibbs_select.gibbs_select = saved
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_gibbs_select_refuses_mixed_devices_and_dtypes(cuda):
    """A CPU/CUDA mix raises ValueError, float16 raises TypeError, and a
    failed build raises RuntimeError; nothing runs the twin instead and
    nothing is counted."""
    import chip_smoke as cs
    from kde_tpu_torch.ops import gibbs_select
    args, codes, kw = cs.k2_inputs(3, cuda, 1, 16, 2, 50, 2, (0, 1),
                                   torch.float32, True, (0, 0), "cdf")
    before = gibbs_select.LAUNCHES
    mixed = args[:5] + (args[5].cpu(),) + args[6:]
    with pytest.raises(ValueError, match="one CUDA device"):
        gibbs_select.gibbs_select(*mixed, codes, **kw)
    half = tuple(a.half() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)
    with pytest.raises(TypeError, match="float32 or float64"):
        gibbs_select.gibbs_select(*half, codes, u=kw["u"].half())
    saved_lib, saved_flags = gibbs_select._lib, gibbs_select.NVCC_FLAGS
    gibbs_select._lib = None
    gibbs_select.NVCC_FLAGS = [*saved_flags, "--no-such-flag"]
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            gibbs_select.gibbs_select(*args, codes, **kw)
    finally:
        gibbs_select._lib, gibbs_select.NVCC_FLAGS = saved_lib, saved_flags
    assert gibbs_select.LAUNCHES == before


def test_blocked_and_user_diffop_take_the_twin_on_card(cuda):
    """On the card cdf and gumbel launch the chain kernel, a lone circular
    diffop gibbs_select; blocked and a user's diffop run the eager twin by
    design and are counted as such."""
    import kde_tpu_torch as kt
    from kde_tpu_torch import manifolds
    from kde_tpu_torch.ops import gibbs_chain, gibbs_select
    rng = np.random.default_rng(22)
    dens = [kt.kde(torch.as_tensor(rng.normal(size=(2, 300)),
                                   dtype=torch.float32, device=cuda), [0.2])
            for _ in range(2)]
    lone = {"diffop": (manifolds.euclid_diff, manifolds.circular_diff)}
    for select, kw, route in (("cdf", {}, "chain"), ("gumbel", {}, "chain"),
                              ("gumbel", lone, "kernel"),
                              ("blocked", {}, "twin"),
                              ("cdf", {"diffop": (lambda a, b: a - b,)},
                               "twin")):
        k0, t0 = gibbs_select.LAUNCHES, gibbs_select.TWIN_STAGES
        c0 = gibbs_chain.LAUNCHES
        kt.prod_appx_ms_gibbs(200, dens, n_iter=2, key=1, select=select, **kw)
        torch.cuda.synchronize()
        assert (gibbs_select.LAUNCHES > k0) == (route == "kernel")
        assert (gibbs_chain.LAUNCHES - c0) == (route == "chain")
        assert (gibbs_select.TWIN_STAGES > t0) == (route == "twin")



# cdf's tile layout: name -> (b, chains as a function of TILE_MIN_ROWS, dn,
# w, d, js, dtype, cov, codes, extras); at the chunk edges (one slot a
# chunk; two slots a chunk past MAX_CHUNKS slots), the threshold width and
# the threshold rows, chains not a multiple of a tile's 16 rows, the
# conditioning stage with padded and dead rows
K2_TILE_CASES = {
    "f32 chunk - 1": (1, lambda r: r + 5, 2, 4 * 512 - 1, 2, (0,), "f32",
                      True, (0, 0), {}),
    "f32 chunk": (1, lambda r: r + 5, 2, 4 * 512, 2, (0,), "f32", True,
                  (0, 0), {}),
    "f32 chunk + 1": (1, lambda r: r + 5, 2, 4 * 512 + 1, 2, (0,), "f32",
                      True, (0, 0), dict(uniform=True)),
    "f32 two-slot chunk - 1": (1, lambda r: r + 5, 2, 41 * 1024 - 1, 2,
                               (1,), "f32", True, (0, 0), {}),
    "f32 two-slot chunk + 1": (1, lambda r: r + 5, 2, 41 * 1024 + 1, 2,
                               (1,), "f32", False, (0, 0),
                               dict(uniform=True)),
    "f64 chunk - 1": (1, lambda r: r + 5, 2, 5 * 256 - 1, 2, (0,), "f64",
                      True, (0, 0), {}),
    "f64 chunk + 1": (1, lambda r: r + 5, 2, 5 * 256 + 1, 2, (0,), "f64",
                      False, (0, 0), {}),
    "threshold width": (1, lambda r: r + 5, 2, 1024, 2, (0,), "f32", True,
                        (0, 0), {}),
    "threshold width + 1": (1, lambda r: r + 5, 2, 1025, 2, (0,), "f32",
                            True, (0, 0), {}),
    "threshold rows - 1": (1, lambda r: r - 1, 2, 3000, 2, (0,), "f32",
                           True, (0, 0), {}),
    "threshold rows": (1, lambda r: r, 2, 3000, 2, (0,), "f32", True,
                       (0, 0), {}),
    "cond pad dead": (2, lambda r: r // 4 + 3, 2, 3000, 2, (0, 1), "f32",
                      False, (0, 0), dict(pad=37, dead=5, mixed=True)),
    "cond pad dead uniform": (2, lambda r: r // 4 + 3, 2, 3000, 2, (0, 1),
                              "f32", False, (0, 0),
                              dict(pad=37, dead=5, mixed=True,
                                   uniform=True)),
    "cond pad dead cov f64": (2, lambda r: r // 4 + 3, 2, 2000, 2, (0, 1),
                              "f64", True, (0, 0),
                              dict(pad=21, dead=7, mixed=True)),
    "circular": (1, lambda r: r + 9, 2, 4000, 1, (1,), "f32", True, (1,),
                 {}),
    "se2 cond": (1, lambda r: r // 2 + 7, 2, 4000, 3, (0, 1), "f32", False,
                 (0, 0, 1), dict(uniform=True)),
}


def _k2_tile(cuda, seed, b, c, dn, w, d, js, dt, cov, codes, ex):
    """chip_smoke.k2_inputs of a tile case; checks that the plan takes the
    tiles exactly where launch_plan says (cdf, w > WARP_MAX_WIDTH, rows >=
    TILE_MIN_ROWS) and returns (args, codes, kw, plan)."""
    import chip_smoke as cs
    from kde_tpu_torch.ops import gibbs_select as gs
    dtype = torch.float32 if dt == "f32" else torch.float64
    args, codes, kw = cs.k2_inputs(seed, cuda, b, c, dn, w, d, js, dtype,
                                   cov, codes, "cdf", **ex)
    plan = gs.launch_plan(w, d, args[0].element_size(), rows=b * c * len(js))
    tiles = w > gs.WARP_MAX_WIDTH and b * c * len(js) >= gs.TILE_MIN_ROWS
    assert (plan.layout == "tiles") == tiles
    return args, codes, kw, plan


def _k2_one_launch(args, codes, kw, name):
    import chip_smoke as cs
    from kde_tpu_torch.ops import gibbs_select
    before = gibbs_select.LAUNCHES
    row, labels = cs.k2_compare(args, codes, kw, name)
    assert gibbs_select.LAUNCHES == before + 1
    assert row["max_abs_err"] == 0.0
    assert len(row["cdf_ties"]) <= cs.K2_MAX_TIES
    assert all(t <= cs.K2_TIE for t in row["cdf_ties"])
    return labels


@pytest.mark.parametrize("name", sorted(K2_TILE_CASES))
def test_gibbs_select_tiles_match_twin(cuda, name):
    """cdf's tile layout against the twin at its edges, with phase 3d's
    limits: labels equal but float64 CDF ties within K2_TIE of u (at most
    K2_MAX_TIES), the gathered stats exact, one launch a call."""
    from kde_tpu_torch.ops import gibbs_select as gs
    b, c_of, *rest = K2_TILE_CASES[name]
    case = _k2_tile(cuda, 70 + sorted(K2_TILE_CASES).index(name), b,
                    c_of(gs.TILE_MIN_ROWS), *rest)
    _k2_one_launch(*case[:3], name)


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("uniform", [False, True], ids=["varied", "uniform"])
@pytest.mark.parametrize("d", list(range(1, 9)) + [17])
def test_gibbs_select_tiles_every_dim(cuda, d, uniform, dt):
    """The tiles at d = 1-8 and 17 (registers for d <= 3, shared memory
    above), float32 and float64, bandwidths uniform (log c once a row) and
    varied, cov on (odd d) and off (the conditioning stage, whose varied
    logs the block takes once a slot), a circular last dim where d > 1,
    mixed active dims."""
    from kde_tpu_torch.ops import gibbs_select as gs
    codes = tuple(int(d > 1 and k == d - 1) for k in range(d))
    args, codes, kw, plan = _k2_tile(
        cuda, 90 + d, 1, gs.TILE_MIN_ROWS // 2 + 3, 2, 1500, d, (0, 1), dt,
        d % 2 == 1, codes, dict(uniform=uniform, mixed=d > 1))
    assert plan.layout == "tiles"
    _k2_one_launch(args, codes, kw, f"tiles d={d}")


def test_gibbs_select_stage_route_of_many_densities(cuda):
    """A keyed cdf product of MAX_DENS + 4 densities takes the stage route
    on the card, one gibbs_select launch a selection step (the tiles at
    its wide levels: more than TILE_MIN_ROWS chains), and agrees with the
    same call on the twin on at least AGREE_MIN of its chains."""
    import chip_smoke as cs
    from kde_tpu_torch.ops import gibbs_select
    out = cs.phase_many_densities(cuda, n=1500,
                                  n_out=gibbs_select.TILE_MIN_ROWS + 104)
    assert out["route"] == "kernel"
    assert out["gibbs_select_launches"] > 0 and out["finite"]
    assert out["twin_same_labels"] >= cs.AGREE_MIN


# ---- the Gibbs chain kernel (csrc/gibbs_chain.cu) --------------------------

K3_CASES = {
    # name: (dtype, n, kwargs of chip_smoke.chain_inputs)
    "replay f64": ("f64", 400, dict(n_out=300, n_iter=3)),
    "keyed f32": ("f32", 3000, {}),
    "block layout f32": ("f32", 6000, dict(n_out=200, n_iter=2)),
    "block layout f64": ("f64", 6000, dict(n_out=100, n_iter=1)),
    "circular": ("f32", 2000, dict(d=1, kinds="c")),
    "se2": ("f32", 2000, dict(d=3, kinds="eec")),
    "circular dn 3": ("f32", 1000, dict(d=1, dn=3, kinds="c")),
    "se2 dn 3": ("f64", 1000, dict(d=3, dn=3, kinds="eec")),
    "partial mask": ("f32", 1500, dict(dn=3, mask=[[1, 0], [1, 1],
                                                   [0, 1]])),
    "dead rows": ("f32", 300, dict(far=True)),
    "B 4": ("f32", 2000, dict(b=4)),
    "dn 3 n_iter 0": ("f32", 1500, dict(dn=3, n_iter=0)),
    "dn 5 d 1": ("f32", 800, dict(dn=5, d=1, n_iter=1)),
    "dn 5 d 2": ("f64", 800, dict(dn=5, d=2, n_iter=1)),
}


# the layouts a case is run on: the launch plan's, the warp and block
# layouts, and (float32, d <= 3) the staged layout
K3_LAYOUTS = ("plan", "warp", "block", "staged")


def _k3_layouts(name):
    dt, _, kw = K3_CASES[name]
    staged = dt == "f32" and kw.get("d", 2) <= 3
    return [lay for lay in K3_LAYOUTS if staged or lay != "staged"]


def _force_layout(monkeypatch, layout):
    """Make gibbs_chain launch ``layout`` (K3_LAYOUTS); "plan" leaves the
    launch plan's own choice."""
    from kde_tpu_torch.ops import gibbs_chain
    if layout != "plan":
        monkeypatch.setattr(gibbs_chain, "launch_plan",
                            lambda *a, **k: layout)


@pytest.mark.parametrize("name,layout", [(n, lay) for n in sorted(K3_CASES)
                                         for lay in _k3_layouts(n)])
def test_gibbs_chain_matches_twin(cuda, monkeypatch, name, layout):
    """The chain kernel against its twin (chip_smoke.py phase 3e's check at
    small sizes) on each layout: every chain's per-level labels and point
    equal, but for listed float64 CDF ties within 1e-12 of u; one launch
    counted."""
    import chip_smoke as cs
    from kde_tpu_torch.ops import gibbs_chain
    _force_layout(monkeypatch, layout)
    dt, n, kw = K3_CASES[name]
    dtype = torch.float32 if dt == "f32" else torch.float64
    args = cs.chain_inputs(sorted(K3_CASES).index(name), cuda, dtype, n, **kw)
    before = gibbs_chain.LAUNCHES
    row, _ = cs.chain_compare(args, name)
    assert gibbs_chain.LAUNCHES == before + 1
    assert row["max_abs_err"] == 0.0
    assert all(c["tie_gap"] <= 1e-12 for c in row["differing"])


@pytest.mark.parametrize("dtype,d", [(torch.float32, 4), (torch.float64, 2),
                                     (torch.float64, 3)])
def test_gibbs_chain_keeps_warp_and_block_layouts_for_f64_and_d4(cuda, dtype,
                                                                 d):
    """Float64 and d = 4 take the warp or block layout (a route by
    shape): the plan says so, the launch is counted, and the chains equal
    the twin's."""
    import chip_smoke as cs
    from kde_tpu_torch.ops import gibbs_chain
    for n, n_out in ((600, 300), (6000, 100)):
        args = cs.chain_inputs(40 + d, cuda, dtype, n, d=d, n_out=n_out,
                               n_iter=2)
        w = max(w for _, w in args[2].offsets)
        assert gibbs_chain.launch_plan(n_out, w, dtype, d) in ("warp",
                                                               "block")
        before = gibbs_chain.LAUNCHES
        row, _ = cs.chain_compare(args, f"{dtype} d={d}")
        assert gibbs_chain.LAUNCHES == before + 1
        assert row["max_abs_err"] == 0.0


@pytest.mark.parametrize("d", range(1, 9))
def test_gibbs_chain_every_dim(cuda, d):
    """Every d up to 8 runs on the chain kernel (d is a runtime bound)."""
    import chip_smoke as cs
    args = cs.chain_inputs(70 + d, cuda, torch.float32, 600, d=d, n_out=256,
                           n_iter=2)
    row, _ = cs.chain_compare(args, f"d={d}")
    assert row["max_abs_err"] == 0.0


@pytest.mark.parametrize("layout", ["plan", "warp", "staged"])
def test_gibbs_chain_set_in_a_batch_equals_its_draw_alone(cuda, monkeypatch,
                                                          layout):
    import chip_smoke as cs
    from kde_tpu_torch.ops import gibbs_chain
    _force_layout(monkeypatch, layout)
    args = cs.chain_inputs(5, cuda, torch.float32, 2000, b=3)
    got = gibbs_chain.gibbs_chain(*args)
    alone = gibbs_chain.gibbs_chain(*cs._set_of(args, 1))
    for a, g in zip(alone, got):
        assert torch.equal(a[0], g[1])


@pytest.mark.parametrize("layout", ["plan", "staged"])
def test_gibbs_chain_partial_last_blocks(cuda, monkeypatch, layout):
    """B = 3 sets of 1,001 chains (not a multiple of the staged layout's
    chains a block): each set's last block is partly empty and no block
    holds two sets, so every set equals its draw alone and the twin's."""
    import chip_smoke as cs
    from kde_tpu_torch.ops import gibbs_chain
    _force_layout(monkeypatch, layout)
    args = cs.chain_inputs(9, cuda, torch.float32, 1500, b=3, n_out=1001,
                           n_iter=2)
    assert 1001 % gibbs_chain.STAGED_CHAINS
    row, got = cs.chain_compare(args, "partial last blocks")
    assert row["max_abs_err"] == 0.0
    for i in range(3):
        alone = gibbs_chain.gibbs_chain(*cs._set_of(args, i))
        for a, g in zip(alone, got):
            assert torch.equal(a[0], g[i])


def test_product_is_one_chain_launch(cuda, monkeypatch):
    """A keyed cdf product, a replay product and a batched sampler each
    launch the chain kernel once and nothing of the stage route: no
    gibbs_select launch and no eager _run_chain between stages."""
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import balltree, gibbs, gibbs_chain, gibbs_select

    def stage_route(*a, **k):
        raise AssertionError("the stage route ran")
    monkeypatch.setattr(gibbs, "_run_chain", stage_route)
    rng = np.random.default_rng(23)
    dens = [kt.kde(torch.as_tensor(rng.normal(size=(2, 800)) + s,
                                   dtype=torch.float32, device=cuda), [0.2])
            for s in (0.0, 0.5)]
    L = balltree.n_levels(600, [800, 800])
    bu, bn = gibbs._stream_sizes(2, 2, L, 3)
    calls = (
        lambda: kt.prod_appx_ms_gibbs(600, dens, n_iter=3, key=2,
                                      select="cdf"),
        lambda: kt.prod_appx_ms_gibbs(600, dens, n_iter=3,
                                      rand_u=rng.uniform(size=600 * bu),
                                      rand_n=rng.normal(size=600 * bn)),
        lambda: kt.BatchedProductSampler([dens] * 3, n_out=600,
                                         n_iter=3).sample(4, select="cdf"))
    for call in calls:
        c0, k0 = gibbs_chain.LAUNCHES, gibbs_select.LAUNCHES
        pts = call()[0]
        torch.cuda.synchronize()
        assert bool(torch.isfinite(pts).all())
        assert gibbs_chain.LAUNCHES == c0 + 1
        assert gibbs_select.LAUNCHES == k0


@pytest.mark.parametrize("name,layout", [(n, lay) for n in sorted(K3_CASES)
                                         for lay in _k3_layouts(n)])
def test_gibbs_chain_gumbel_matches_twin(cuda, monkeypatch, name, layout):
    """Gumbel on the chain kernel against its twin on each layout: every
    chain's per-level labels and point equal (the counter noise is the
    twin's, the argmaxes exact); one launch counted."""
    import chip_smoke as cs
    from kde_tpu_torch.ops import gibbs_chain
    _force_layout(monkeypatch, layout)
    dt, n, kw = K3_CASES[name]
    dtype = torch.float32 if dt == "f32" else torch.float64
    args = cs.chain_inputs(50 + sorted(K3_CASES).index(name), cuda, dtype, n,
                           select="gumbel", **kw)
    before = gibbs_chain.LAUNCHES
    row, _ = cs.chain_compare(args, f"gumbel {name}")
    assert gibbs_chain.LAUNCHES == before + 1
    assert row["same_share"] == 1.0 and row["max_abs_err"] == 0.0


def test_gumbel_dead_shortcut_on_card(cuda):
    """Rows whose max logit lies a few ulps either side of log(1e-99),
    with 0 to 400 other candidates just under it: gibbs_select's gumbel
    labels (the sum of exps taken only below the threshold) equal the
    twin's (_dead_predicate on every row) on every row, in float32 and
    float64, on the warp and block layouts."""
    from kde_tpu_torch.ops import gibbs_select
    for dtype in (torch.float32, torch.float64):
        for w in (500, 1500):
            thr = torch.tensor(gibbs_select.LOG_DEAD, dtype=torch.float64)
            rows, c = [], 0
            for steps in range(-4, 5):
                for others in (0, 3, 400):
                    rows.append((float(thr) + steps * 2e-6 * (1 + c % 3),
                                 others))
                    c += 1
            c = len(rows)
            # d = 1, bandwidth 1, query 0: logit_i = logw_i - (m_i^2 + 0) / 2
            logw = torch.full((1, 1, w), -np.inf, dtype=torch.float64)
            logw[..., :410] = np.log(1.0 / 410)
            mean = torch.zeros((1, 1, w, 1), dtype=torch.float64)
            # one slab a chain: each chain selects from its own level copy
            mu = torch.zeros((1, c, 1), dtype=torch.float64)
            labels = []
            for ci, (top, others) in enumerate(rows):
                m = mean.clone()
                m[0, 0, 0, 0] = np.sqrt(2 * (np.log(1.0 / 410) - top))
                m[0, 0, 1:1 + others, 0] = np.sqrt(
                    2 * (np.log(1.0 / 410) - top + 1e-3))
                m[0, 0, 1 + others:410, 0] = 100.0
                args = [x.to(cuda, dtype) for x in (
                    m, torch.ones_like(m), logw, mu[:, ci:ci + 1])]
                perm = torch.arange(w, device=cuda)[None, None]
                act = torch.ones((1, 1, 1), dtype=torch.bool, device=cuda)
                seeds = torch.tensor([[ci, 77]], device=cuda)
                call = (args[0], args[1], args[2], perm, (0,), args[3], None,
                        act, (0,))
                got = gibbs_select.gibbs_select(*call, seeds=seeds,
                                                chain0=ci, sel0=3)[2]
                want = gibbs_select.gibbs_select_ref(*call, seeds=seeds,
                                                     chain0=ci, sel0=3)[2]
                assert torch.equal(got, want), (dtype, w, top, others)
                labels.append(int(got))
            assert len(set(labels)) > 1


def test_gumbel_product_is_one_chain_launch(cuda, monkeypatch):
    """A keyed gumbel ``*``, ProductSampler, BatchedProductSampler,
    product_batched, a device-built plan and an SE(2) product each launch
    the chain kernel once (the `*` and product_batched with
    config.GIBBS_SELECT = "gumbel") and gibbs_select never."""
    import kde_tpu_torch as kt
    from kde_tpu_torch import config, manifolds as m
    from kde_tpu_torch.ops import gibbs, gibbs_chain, gibbs_select

    def stage_route(*a, **k):
        raise AssertionError("the stage route ran")
    rng = np.random.default_rng(24)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=cuda)
    dens = [kt.kde(f32(rng.normal(size=(2, 800)) + s), [0.2])
            for s in (0.0, 0.5)]
    se2 = dict(addop=(m.euclid_add, m.euclid_add, m.circular_add),
               diffop=(m.euclid_diff, m.euclid_diff, m.circular_diff),
               get_mu=(m.euclid_mu, m.euclid_mu, m.circular_mu),
               get_lambda=(m.euclid_lambda, m.euclid_lambda,
                           m.circular_lambda))
    poses = [kt.kde(f32(np.vstack([rng.normal(size=(2, 500)),
                                   np.pi - 0.1 * rng.random((1, 500))])),
                    [0.2], **se2) for _ in range(2)]
    calls = {
        "keyed *": lambda: (dens[0] * dens[1]).points,
        "ProductSampler": lambda: kt.ProductSampler(
            dens, n_out=600, n_iter=3).sample(1, select="gumbel")[0],
        "BatchedProductSampler": lambda: kt.BatchedProductSampler(
            [dens] * 3, n_out=600, n_iter=3).sample(2, select="gumbel")[0],
        "product_batched": lambda: kt.product_batched([dens] * 2)[0].points,
        "device plan": lambda: kt.prod_appx_ms_gibbs(
            600, dens, n_iter=3, key=3, plan="device", select="gumbel")[0],
        "se2": lambda: kt.prod_appx_ms_gibbs(600, poses, n_iter=3, key=4,
                                             select="gumbel", **se2)[0]}
    monkeypatch.setattr(config, "GIBBS_SELECT", "gumbel")
    monkeypatch.setattr(gibbs, "_run_chain", stage_route)
    for name, call in calls.items():
        c0, k0 = gibbs_chain.LAUNCHES, gibbs_select.LAUNCHES
        pts = call()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(pts).all()), name
        assert gibbs_chain.LAUNCHES == c0 + 1, name
        assert gibbs_select.LAUNCHES == k0, name


def test_gibbs_chain_refuses_bad_inputs_and_a_failed_build(cuda):
    """A CPU/CUDA mix raises ValueError, float16 raises TypeError, and a
    failed build raises RuntimeError; nothing runs the twin instead and
    nothing is counted."""
    import chip_smoke as cs
    from kde_tpu_torch.ops import gibbs_chain
    u, nrm, plans, m, n_iter, ent, codes = cs.chain_inputs(
        6, cuda, torch.float32, 200, n_out=64, n_iter=1)
    before = gibbs_chain.LAUNCHES
    with pytest.raises(ValueError, match="one CUDA device"):
        gibbs_chain.gibbs_chain(u.cpu(), nrm, plans, m, n_iter, ent, codes)
    with pytest.raises(TypeError, match="float32 or float64"):
        gibbs_chain.gibbs_chain(u.half(), nrm, plans, m, n_iter, ent, codes)
    with pytest.raises(ValueError, match="codes"):
        gibbs_chain.gibbs_chain(u, nrm, plans, m, n_iter, ent, None)
    saved_lib, saved_flags = gibbs_chain._lib, gibbs_chain.NVCC_FLAGS
    gibbs_chain._lib = None
    gibbs_chain.NVCC_FLAGS = [*saved_flags, "--no-such-flag"]
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            gibbs_chain.gibbs_chain(u, nrm, plans, m, n_iter, ent, codes)
    finally:
        gibbs_chain._lib, gibbs_chain.NVCC_FLAGS = saved_lib, saved_flags
    assert gibbs_chain.LAUNCHES == before


# ---- the kernel-sharded selection (ops/sharded_select.py, K6) ------------

K6_CASES = {
    # name: (chains, w, d, js, dtype, cov, codes, shards, extras)
    "cond S=1": (256, 5000, 2, (0, 1), "f32", False, (0, 0), 1, {}),
    "sweep S=2": (256, 5000, 2, (1,), "f32", True, (0, 0), 2, {}),
    "f64 cond S=2": (128, 2000, 2, (0, 1), "f64", False, (0, 0), 2, {}),
    "d=1 S=2": (128, 700, 1, (0, 1), "f32", True, (0,), 2, {}),
    "d=3 f64 S=1": (128, 700, 3, (1,), "f64", True, (0, 0, 0), 1, {}),
    "circular S=2": (256, 3000, 1, (0, 1), "f32", False, (1,), 2, {}),
    "se2 S=2": (256, 3000, 3, (1,), "f32", True, (0, 0, 1), 2, {}),
    "dead pad S=2": (300, 900, 2, (0, 1), "f32", False, (0, 0), 2,
                     dict(pad=600, dead=4, mixed=True)),
    "dead pad f64 S=2": (300, 900, 2, (1,), "f64", True, (0, 0), 2,
                         dict(pad=600, dead=4)),
    "dn=3 S=2": (128, 1500, 2, (0, 1, 2), "f32", False, (0, 0), 2,
                 dict(dn=3)),
    "w 1024 S=1": (64, 1024, 2, (0,), "f32", True, (0, 0), 1, {}),
    "w 1025 S=1": (64, 1025, 2, (0,), "f64", True, (0, 0), 1, {}),
    "w 2049 S=2": (64, 2049, 2, (1,), "f32", True, (0, 0), 2, {}),
}


def _k6_case(name, cuda):
    import chip_smoke as cs
    c, w, d, js, dt, cov, codes, shards, ex = K6_CASES[name]
    dtype = torch.float32 if dt == "f32" else torch.float64
    return cs.k6_inputs(sorted(K6_CASES).index(name), cuda, dtype, c, w, d,
                        js, cov, codes, shards, **ex)


@pytest.mark.parametrize("name", sorted(K6_CASES))
def test_sharded_select_matches_twin(cuda, name):
    """K6's six phases against their twins, the shards composed on one
    rank (chip_smoke.py phase 3g's check): maxima, dead rows and fallback
    maxima equal, sums within their order's rounding, the global index on
    every row but float64 CDF ties within 1e-12 of u, each listed; the
    winner's stats equal at equal indices; six launches a shard."""
    import chip_smoke as cs
    inp = _k6_case(name, cuda)
    row = cs.k6_compare(inp, name)
    assert row["launches"] == 6 * inp["n_shards"]
    assert row["max_abs_err"] == 0.0
    assert all(t <= 1e-12 for t in row["cdf_ties"])
    if K6_CASES[name][-1].get("dead"):
        assert row["dead_rows"] > 0


# widths of a shard's slice: one candidate, the plan's chunk boundaries
# (chip_smoke.k6_chunk_widths, computed on the card) and the main path's
K6_WIDTHS = ("1", "chunk-1", "chunk", "chunk+1", "n chunks-1", "n chunks",
             "n chunks, last 1", "50k", "1M")
K6_VARIANTS = {
    # name: (chains, dtype, cov, codes, shards, extras)
    "f32 uniform cov S=1": (256, "f32", True, (0, 0), 1,
                            dict(uniform="all")),
    "f64 varied dead S=2": (64, "f64", False, (0, 0), 2, dict(dead=5)),
    "f32 circular half-uniform dead S=2": (256, "f32", True, (0, 1), 2,
                                           dict(uniform="half", dead=3)),
}


@pytest.mark.parametrize("variant", sorted(K6_VARIANTS))
@pytest.mark.parametrize("width", K6_WIDTHS)
def test_sharded_select_chunk_boundaries(cuda, width, variant):
    """K6 against its twins (k6_compare's limits, six launches a shard) at
    the widths of K6_WIDTHS, each shard holding that many candidates:
    uniform and varied bandwidths, cov on and off, circular codes, float32
    and float64, S = 1 and 2, dead rows."""
    import chip_smoke as cs
    from kde_tpu_torch.ops import sharded_select as ss
    c, dt, cov, codes, shards, ex = K6_VARIANTS[variant]
    dtype = torch.float32 if dt == "f32" else torch.float64
    item = 4 if dt == "f32" else 8
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    widths = dict(cs.k6_chunk_widths(c, 1, 2, item, sms), **{
        "1": 1, "50k": 50_000, "1M": 1_000_000})
    w_loc = widths[width]
    inp = cs.k6_inputs(K6_WIDTHS.index(width), cuda, dtype, c,
                       shards * w_loc, 2, (1,), cov, codes, shards, **ex)
    assert inp["rows"][0].mean.shape[1] == w_loc
    row = cs.k6_compare(inp, f"{width} {variant}")
    assert row["launches"] == 6 * shards
    assert row["max_abs_err"] == 0.0
    if ex.get("dead"):
        assert row["dead_rows"] > 0
    pl = ss.prepare(inp["rows"][0]).plan
    assert pl.chunks <= ss.MAX_CHUNKS


def test_sharded_select_stage_contract(cuda):
    """The packed stage matches the source (its size is checked at load,
    each launch's shared memory against the plan's), uniform flags are
    bitwise per candidate, and count_below on the card takes only the
    Stage whose exp_sum ran on the same gmax and dead."""
    import chip_smoke as cs
    from kde_tpu_torch.ops import sharded_select as ss
    inp = cs.k6_inputs(3, cuda, torch.float32, 256, 40_000, 2, (0, 1), True,
                       (0, 0), 1, uniform="dim0")
    rows = inp["rows"][0]
    st = ss.prepare(rows)
    lib = ss._load()
    assert lib.kde_k6_smem(st._addr, 0) == st.plan.tile_smem
    assert lib.kde_k6_smem(st._addr, 3) == st.plan.count_smem
    assert st.uniform.tolist() == [[True, False], [True, False]]
    pre = cs.k6_select(inp)
    g, dead = pre["gmax"], pre["dead"]
    with pytest.raises(ValueError, match="Stage"):
        ss.count_below(rows, g, dead, pre["tots"], 0, inp["u"])
    with pytest.raises(ValueError, match="Stage"):
        ss.count_below(st, g, dead, pre["tots"], 0, inp["u"])   # no exp_sum
    ss.exp_sum(st, g, dead)
    with pytest.raises(ValueError, match="Stage"):
        ss.count_below(st, g.clone(), dead, pre["tots"], 0, inp["u"])
    z = ss.count_below(st, g, dead, pre["tots"], 0, inp["u"])
    assert torch.equal(z, pre["counts"][0])


def test_kernel_sharded_replay_on_k6(nccl_world, cuda, monkeypatch):
    """A float64 replay product through the kernel-sharded engine at S = 1
    runs every selection on K6 (six launches a selection, no twin stage)
    and equals the same call on the twins (the same collectives; K6's
    route is one chain block) and, but for CDF ties, the plain engine."""
    import kde_tpu_torch as kt
    from kde_tpu_torch import parallel as par
    from kde_tpu_torch.ops import balltree, gibbs, sharded_select
    from kde_tpu_torch.parallel import gibbs_kernel_sharded as gks
    rng = np.random.default_rng(23)
    f64 = dict(dtype=torch.float64, device=cuda)
    dens = [kt.kde(torch.as_tensor(rng.normal(size=(2, 500)) + s, **f64),
                   [0.2]) for s in (0.0, 0.5)]
    n_out, n_iter = 300, 3
    L = balltree.n_levels(n_out, [500, 500])
    bu, bn = gibbs._stream_sizes(2, 2, L, n_iter)
    ru, rn = rng.uniform(size=n_out * bu), rng.normal(size=n_out * bn)
    mesh = par.make_mesh_2d((1, 1))
    call = lambda: par.prod_appx_ms_gibbs_kernel_sharded(
        mesh, n_out, dens, n_iter=n_iter, rand_u=ru, rand_n=rn,
        record_labels=True)
    k0, t0 = sharded_select.LAUNCHES, sharded_select.TWIN_STAGES
    got = call()
    torch.cuda.synchronize()
    assert sharded_select.LAUNCHES - k0 == 6 * L * (1 + n_iter * 2)
    assert sharded_select.TWIN_STAGES == t0
    monkeypatch.setattr(gks, "_route", lambda *a: "twin")
    want = call()
    assert sharded_select.TWIN_STAGES - t0 == L * (1 + n_iter * 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, plain = kt.prod_appx_ms_gibbs(n_out, dens, n_iter=n_iter, rand_u=ru,
                                     rand_n=rn)
    assert float((got[1] == plain).all(dim=0).double().mean()) >= 0.99


def test_sharded_select_refuses_bad_inputs_and_a_failed_build(cuda):
    """A CPU/CUDA mix raises ValueError, a user's diffop raises on the card
    (it belongs to the twins), and a failed build raises RuntimeError;
    nothing runs the twin instead and nothing is counted."""
    from kde_tpu_torch.ops import sharded_select as ss
    rows = _k6_case("w 1024 S=1", cuda)["rows"][0]
    before = ss.LAUNCHES
    with pytest.raises(ValueError, match="one CUDA device"):
        ss.local_max(rows._replace(mu=rows.mu.cpu()))
    with pytest.raises(ValueError, match="twins"):
        ss.local_max(rows._replace(diffop=(lambda a, b: a - b,) * 2))
    with pytest.raises(TypeError):
        ss.local_max(rows._replace(mu=rows.mu.double()))
    saved_lib, saved_flags = ss._lib, ss.NVCC_FLAGS
    ss._lib = None
    ss.NVCC_FLAGS = [*saved_flags, "--no-such-flag"]
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            ss.local_max(rows)
    finally:
        ss._lib, ss.NVCC_FLAGS = saved_lib, saved_flags
    assert ss.LAUNCHES == before


# ---- the LOOCV golden search in one launch (ops/loo_search.py, K4) --------

K4_TOL = 1e-2          # the search's tolerance (kde's default)


def _k4_case(cuda, r, n, dtype, zero=0, seed=0):
    """Rows [r, n] of N(0, s^2) data, s per row, weights uniform but for a
    zero-weight tail of ``zero`` points; the bracket of ksize_rows."""
    from kde_tpu_torch.ops import loocv
    rng = np.random.default_rng(seed + r * 7 + n)
    rows = torch.as_tensor(rng.normal(size=(r, n))
                           * rng.uniform(0.5, 2.0, size=(r, 1)),
                           dtype=dtype, device=cuda)
    w = np.ones(n)
    w[n - zero:] = 0.0
    w = torch.as_tensor(w / w.sum(), dtype=dtype, device=cuda)
    base, ax, bx, cx = loocv.bracket_rows(rows, *loocv._slices_on(n, cuda))
    return rows, w, (base ** 2).contiguous(), ax, bx, cx


K4_CASES = {"2x20000": (2, 20000, 0), "2x4096": (2, 4096, 0),
            "6x3": (6, 3, 0), "3x2": (3, 2, 0), "2x1": (2, 1, 0),
            "zero_tail_3x500": (3, 500, 120), "8x1500": (8, 1500, 0),
            "2x256": (2, 256, 0), "2x1100": (2, 1100, 0),
            "12x1000": (12, 1000, 0), "2x2048": (2, 2048, 0),
            "zero_tail_2x300": (2, 300, 61)}


@pytest.mark.parametrize("name", sorted(K4_CASES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_loo_search_matches_twin_on_card(cuda, name, dtype):
    """K4 against its twin on the card (the route ksize_rows would give
    the twin).  float64 follows the twin's trajectory: rtol 1e-10.
    float32: every probe K4 reports is within 2e-5 relative of the twin's
    entropy at the same x (non-finite values equal), and the pick within
    the final bracket, tol (|x1| + |x2|) = 2 tol relative: a comparison
    of two entropies within the float32 sums' noise may go the other way
    in the twin."""
    from kde_tpu_torch.ops import loo_search, loocv
    dt = getattr(torch, dtype)
    r, n, zero = K4_CASES[name]
    args = _k4_case(cuda, r, n, dt, zero)
    impl = loocv.select_loo_impl(n, dt)
    trace = loo_search.new_trace(args[0], K4_TOL)
    before = loo_search.LAUNCHES
    got = loo_search.loo_search(*args, tol=K4_TOL, impl=impl, trace=trace)
    torch.cuda.synchronize()
    assert loo_search.LAUNCHES == before + 1 and got.is_cuda
    want = loo_search.loo_search_ref(*args, tol=K4_TOL, impl=impl)
    if dt == torch.float64:
        torch.testing.assert_close(got, want, rtol=1e-10, atol=0,
                                   equal_nan=True)
        return
    torch.testing.assert_close(got, want, rtol=2 * K4_TOL, atol=0,
                               equal_nan=True)
    nloo = loo_search.make_nloo(args[0], args[2], args[1], impl, 1024)
    x, f = trace[:, :, 0], trace[:, :, 1]
    for k in range(x.shape[1]):
        live = ~torch.isnan(x[:, k])
        if not bool(live.any()):
            break
        fw = nloo(torch.where(live, x[:, k], torch.ones_like(x[:, k])))
        fin = live & torch.isfinite(fw)
        torch.testing.assert_close(f[fin, k], fw[fin], rtol=2e-5, atol=0)
        torch.testing.assert_close(f[live & ~fin, k], fw[live & ~fin],
                                   rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ksize_rows_is_one_launch_without_a_host_sync(cuda, dtype):
    """ksize_rows and the fit device_fit_arrays of CUDA tensors: one K4
    launch each and no host sync (the node table is uploaded once per n,
    before the checked region)."""
    from kde_tpu_torch.ops import loo_search, loocv
    dt = getattr(torch, dtype)
    rows = _k4_case(cuda, 2, 20000, dt)[0]
    lo, hi = loocv._slices_on(20000, rows.device)
    w = torch.full((20000,), 1.0 / 20000, dtype=dt, device=cuda)
    torch.cuda.synchronize()
    before = loo_search.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        bw = loocv.ksize_rows(rows, w, lo, hi)
        pts, var, wf = loocv.device_fit_arrays(rows)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert loo_search.LAUNCHES == before + 2
    assert bool((bw > 0).all()) and torch.equal(var[0], bw ** 2)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_loo_search_repeats_bit_for_bit(cuda, dtype):
    from kde_tpu_torch.ops import loo_search
    args = _k4_case(cuda, 8, 3000, getattr(torch, dtype), zero=100)
    first = loo_search.loo_search(*args)
    for _ in range(9):
        assert torch.equal(loo_search.loo_search(*args), first)


# K4's plans: shapes of the rows plan on a cluster and at per-row
# counters, at tile edges, MAX_ROWS rows, and its largest rows (near a
# block's shared memory: 16,384 float32 points, 12,000 float64): name ->
# (rows, points, zero-weight tail, dtypes)
K4_PLAN_CASES = {"2x256": (2, 256, 0, ("float32", "float64")),
                 "2x1000": (2, 1000, 0, ("float32", "float64")),
                 "12x1000": (12, 1000, 0, ("float32", "float64")),
                 "2x1023": (2, 1023, 0, ("float32", "float64")),
                 "2x1025": (2, 1025, 7, ("float32", "float64")),
                 "3x2049": (3, 2049, 0, ("float32", "float64")),
                 "1024x300": (1024, 300, 40, ("float32", "float64")),
                 "2x16384": (2, 16384, 0, ("float32",)),
                 "12x16384": (12, 16384, 0, ("float32",)),
                 "2x12000": (2, 12000, 0, ("float64",)),
                 "12x12000": (12, 12000, 0, ("float64",))}


@pytest.mark.parametrize("name,dtype", [
    (name, dt) for name, (_, _, _, dts) in sorted(K4_PLAN_CASES.items())
    for dt in dts])
def test_loo_search_rows_plan_matches_grid_plan_bitwise(cuda, name, dtype):
    """The rows plan (each block keeps its row resident, a row's blocks
    meet at their own barrier) gives the grid plan's picks and probe
    trace bit for bit, and repeated calls give equal bits; rows past
    ROWS_MAX_N take the grid plan in the wrapper."""
    from kde_tpu_torch.ops import loo_search
    r, n, zero, _ = K4_PLAN_CASES[name]
    dt = getattr(torch, dtype)
    args = _k4_case(cuda, r, n, dt, zero=zero)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = loo_search._rows_plan(r, n, dt, sms)
    assert plan.layout == "rows", plan
    lib = loo_search._load()
    got = {}
    for side, pl in (("grid", loo_search.GRID), ("rows", plan)):
        trace = loo_search.new_trace(args[0], K4_TOL)
        got[side] = (loo_search.launch(lib, *args, K4_TOL, trace, pl), trace)
    for a, b in zip(got["grid"], got["rows"]):
        assert torch.equal(a.view(torch.int64 if dt == torch.float64
                                  else torch.int32),
                           b.view(torch.int64 if dt == torch.float64
                                  else torch.int32)), plan
    for _ in range(3):
        assert torch.equal(loo_search.launch(lib, *args, K4_TOL, None, plan),
                           got["rows"][0])
    want = loo_search.launch_plan(r, n, dt, sms)
    assert want == (plan if n <= loo_search.ROWS_MAX_N[dt]
                    else loo_search.GRID)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_loo_search_rows_plan_duplicate_points(cuda, dtype):
    """Rows of many duplicate points (nearest-neighbour shift 0) on the
    rows plan: bitwise the grid plan's, and float64 on the twin's
    trajectory."""
    from kde_tpu_torch.ops import loo_search, loocv
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(11)
    rows = torch.as_tensor(np.round(rng.normal(size=(3, 700)) * 4) / 4,
                           dtype=dt, device=cuda)
    w = torch.full((700,), 1 / 700, dtype=dt, device=cuda)
    base, ax, bx, cx = loocv.bracket_rows(rows, *loocv._slices_on(700, cuda))
    args = (rows, w, (base ** 2).contiguous(), ax, bx, cx)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = loo_search.launch_plan(3, 700, dt, sms)
    assert plan.layout == "rows"
    lib = loo_search._load()
    got = loo_search.launch(lib, *args, K4_TOL, None, plan)
    assert torch.equal(got, loo_search.launch(lib, *args, K4_TOL))
    if dt == torch.float64:
        want = loo_search.loo_search_ref(*args, tol=K4_TOL)
        torch.testing.assert_close(got, want, rtol=1e-10, atol=0)


def test_loo_search_refuses_bad_inputs_and_a_failed_build(cuda):
    """A CPU/CUDA mix raises ValueError, float16 TypeError and a failed
    build RuntimeError; nothing runs the twin instead and nothing is
    counted."""
    from kde_tpu_torch.ops import loo_search
    rows, w, bv, ax, bx, cx = _k4_case(cuda, 2, 500, torch.float32)
    before = loo_search.LAUNCHES
    with pytest.raises(ValueError, match="one CUDA device"):
        loo_search.loo_search(rows.cpu(), w, bv, ax, bx, cx)
    with pytest.raises(TypeError, match="float32 or float64"):
        loo_search.loo_search(rows.half(), w.half(), bv.half(), ax.half(),
                              bx.half(), cx.half())
    saved_lib, saved_flags = loo_search._lib, loo_search.NVCC_FLAGS
    loo_search._lib = None
    loo_search.NVCC_FLAGS = [*saved_flags, "--no-such-flag"]
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            loo_search.loo_search(rows, w, bv, ax, bx, cx)
    finally:
        loo_search._lib, loo_search.NVCC_FLAGS = saved_lib, saved_flags
    assert loo_search.LAUNCHES == before


# sha256 of K4's picks and probe trace at each case (the bytes of xmin,
# then of the trace), recorded on an H100 from csrc/loo_search.cu as it
# was before its probe arithmetic moved into csrc/loo_probe.cuh: the move
# must leave every bit where it was, and so must the rows plan, which the
# cases up to 16,384 points now take.
K4_BITS = {
    "2x1 float32":
        "f8e475d02d53fccf2417f7a53395f913b7f0b91648412e72a1766182ca572f63",
    "2x1 float64":
        "903f0a82cb374375f795cfab91149596532f197ac5280f02da12c9badc307b9e",
    "2x20000 float32":
        "7f17e0dc43a1a1e9e28e8f8754465cacd77709a69610722e0ee26097785e2bba",
    "2x20000 float64":
        "a866d112c2561357579d1d440afe61c5069f87644162657d3ca9e5f84a817766",
    "2x4096 float32":
        "792501a54d7b853873e31d3cfca066ddb46edabb17d26aa732cbaf72cd8902cb",
    "2x4096 float64":
        "98fad610f37e5b1ae4d5f0220c1f34e4d27595b5dbe5310e0329283c40b934d1",
    "3x2 float32":
        "1afbd824bf1b4a0fead6160d2175dc4d6f999a67316ae9ddb80bfa2a6e435d58",
    "3x2 float64":
        "08003f14210fe21080c7b2d1ddd87878696ca1b1e3051fb37190d4b7e880fc1b",
    "6x3 float32":
        "681d6a3aaad2a5f0214ca8ed66233b5d08318d4973d11a0cafdb453611b8f398",
    "6x3 float64":
        "89cb376bf735ea39b1abd9a4eb9a46e1861a9b723c8f962f8330b8be5ebe14b4",
    "8x1500 float32":
        "7169afb6ee18562a0e89a55694bafbb706a621855a10b8340446f9d05970adc2",
    "8x1500 float64":
        "38449f89a46b0a6105e0ba9ca64ed02fba6a6802eee7aa174651f8e6e9cdd00f",
    "zero_tail_3x500 float32":
        "113bb8b2c28e3e455aec55288f624ab7182dffc7f7dd687724fc9f4608fd04ae",
    "zero_tail_3x500 float64":
        "5e63c2ae24b9313aba5077e3d093065590d2c7673f7e89338e00ebee675b2c0a",
    # recorded on an H100 from the grid plan, the one layout of
    # csrc/loo_search.cu before the rows plan was added
    "2x256 float32":
        "b7cf625a6cf46d951828455c78fa26eb77defe323e2ec088664f4eecc54edb45",
    "2x256 float64":
        "fbd0c6ae0de256ae78cf0f9f8dba34ba72ea3c0c685e9ac9d645c050479b38e3",
    "2x1100 float32":
        "130b130cb0d703c99d9d76f0777c644c4617ddebb5fd10ce582a39504c996096",
    "2x1100 float64":
        "fe3bd98ea42679351a7077f22123415f5173b6097b54182b63ca3f6b1f84b34d",
    "12x1000 float32":
        "e68402237e4c7c9430c7d96a6cde97fdd5c280993d723d5469a45e905c9fd0a2",
    "12x1000 float64":
        "391d33c7dd62705df4cfa1d11afad27cba94212e0f64e094daae1be6bdd615b1",
    "2x2048 float32":
        "7c12f293f48f3f7cbcc1bbda44cc2e5cb5404908e11c3b84b994ecdb3943d40e",
    "2x2048 float64":
        "27122a848fe0580977c481c574d12336d18b064d9814cc15d6dd868dffa7934e",
    "zero_tail_2x300 float32":
        "0954d999d3b7c669c5a708a980836f3e5aaf1e8a43f465d63da7abdbeb3ebe26",
    "zero_tail_2x300 float64":
        "97822417434c550d247bc6d7ccff1c81a2909908d44f8f32b976b4f49bd7fe86",
}


@pytest.mark.parametrize("name", sorted(K4_CASES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_loo_search_bits_unchanged_by_the_probe_header(cuda, name, dtype):
    import hashlib
    from kde_tpu_torch.ops import loo_search
    r, n, zero = K4_CASES[name]
    args = _k4_case(cuda, r, n, getattr(torch, dtype), zero=zero)
    trace = loo_search.new_trace(args[0], K4_TOL)
    xmin = loo_search.loo_search(*args, tol=K4_TOL, trace=trace)
    digest = hashlib.sha256(xmin.cpu().numpy().tobytes()
                            + trace.cpu().numpy().tobytes()).hexdigest()
    assert digest == K4_BITS[f"{name} {dtype}"], \
        f"K4 bits {name} {dtype}: {digest}"


def test_loo_search_takes_a_launch_a_max_rows(cuda):
    """More than MAX_ROWS rows take a launch for each MAX_ROWS of them, and
    each row's pick is the one it gets in a launch of its own rows."""
    from kde_tpu_torch.ops import loo_search
    rows, w, bv, ax, bx, cx = _k4_case(cuda, 3, 200, torch.float32)
    many = loo_search.MAX_ROWS + 2
    big = [t.repeat(-(-many // 3), *([1] * (t.dim() - 1)))[:many]
           .contiguous() for t in (rows, bv, ax, bx, cx)]
    before = loo_search.LAUNCHES
    got = loo_search.loo_search(big[0], w, *big[1:])
    torch.cuda.synchronize()
    assert loo_search.LAUNCHES == before + 2 and got.shape == (many,)
    alone = loo_search.loo_search(rows, w, bv, ax, bx, cx)
    assert torch.equal(got, alone.repeat(-(-many // 3))[:many])


# ---- the sharded LOOCV search (ops/sharded_loo.py, K7) --------------------

def _k7_shards(cuda, n, dtype, zero=0, seed=0, ranks=4):
    """Points [n, 2] of N(0, s^2) data with non-uniform weights (a zero
    tail of ``zero`` points, as padding), their sort bracket, and the query
    rows of ``ranks`` ranks (every column on each)."""
    from kde_tpu_torch.ops import loocv
    rng = np.random.default_rng(seed + n)
    pts = rng.normal(size=(n, 2)) * [1.0, 2.5]
    w = rng.uniform(0.5, 1.5, size=n)
    w[n - zero:] = 0.0
    t = lambda x: torch.as_tensor(x / (x.sum() if x.ndim == 1 else 1.0),
                                  dtype=dtype, device=cuda)
    pts, w = t(pts), t(w)
    base, ax, bx, cx = loocv.bracket_rows(pts.T.contiguous(),
                                          *loocv._slices_on(n, cuda))
    m = -(-n // ranks)
    return pts, w, (base, ax, bx, cx), [(a, min(n, a + m))
                                        for a in range(0, n, m)]


def _k7_rank(pts, w, bracket, a, b, **kw):
    from kde_tpu_torch.ops import loo_search, sharded_loo as sl
    base, ax, bx, cx = bracket
    q = pts[a:b]
    xs, wp, st, fl = sl.stage(pts, w, ax, bx, cx)
    return sl.sweeps(q, w[a:b], xs, wp, sl.nn_shift(q, xs, wp, a), base, st,
                     fl, q0=a, tol=K4_TOL,
                     trace=loo_search.new_trace(pts.T, K4_TOL), **kw)


def _k7_phase_pairs(pts, w, bracket, ranks):
    """Each K7 launch of sweeps 0-2 and the closing step on the card and on
    its twin, from the same inputs, over a query split with every column
    on each rank, the psum composed by hand (the twin's heads fold the
    kernels' summed entropies): pairs of (name, kernel output, twin
    output)."""
    from kde_tpu_torch.ops import sharded_loo as sl
    base, ax, bx, cx = bracket
    out = []
    got = sl.stage(pts, w, ax, bx, cx)
    want = sl.stage_ref(pts, w, ax, bx, cx)
    for k in range(2):
        out.append((f"stage {k}", got[k], want[k]))
    out.append(("stage st", got[2][0], want[2][0]))
    out.append(("stage fl", got[3][0], want[3][0]))
    sides = []
    for a, b in ranks:
        pair = [_k7_rank(pts, w, bracket, a, b) for _ in range(2)]
        out.append((f"nn_shift {a}", pair[0].shift, sl.nn_shift_ref(
            pts[a:b], pair[0].xs, pair[0].wp, a)))
        sides.append(pair)
    for s in (0, 1, 2):
        for (k, t), (a, _) in zip(sides, ranks):
            sl.sweep(k, s)
            sl.sweep_ref(t, s)
            out.append((f"sweep ent {s} {a}", k.ent_v[s].clone(),
                        t.ent_v[s].clone()))
            for name in ("st", "fl"):
                out.append((f"sweep {name} {s} {a}",
                            getattr(k, name)[s & 1].clone(),
                            getattr(t, name)[s & 1].clone()))
            out.append((f"sweep flag {s} {a}", k.flag_v[s].clone(),
                        t.flag_v[s].clone()))
            out.append((f"sweep trace {s} {a}", k.trace.clone(),
                        t.trace.clone()))
        total = sum(k.ent_v[s] for k, _ in sides)
        for pair in sides:
            for side in pair:
                side.ent_v[s].copy_(total)
    k, t = sides[0]
    res = []
    for side, fn in ((k, sl.golden_step), (t, sl.golden_step_ref)):
        flag = side.flags[:1].clone()
        fn(side.ent_v[2], base, side.st, side.fl, side.xmin, flag, 2,
           K4_TOL, side.trace)
        res.append((side.st[1], side.fl[1], side.xmin, flag, side.trace))
    for name, g, h in zip(("st", "fl", "xmin", "flag", "trace"), *res):
        out.append((f"golden_step {name}", g, h))
    return out


K7_CASES = {"4x3000": (3000, 0), "4x2333_pad": (2333, 17),
            "4x70": (70, 3), "1x9000": (9000, 5)}


@pytest.mark.parametrize("name", sorted(K7_CASES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_loo_launches_match_twins(cuda, name, dtype):
    """Every K7 launch of sweeps 0-2 and the closing step against its twin
    over a query split (4 ranks, or 1) with every column on each rank (the
    diagonal at the ranks' offsets, several tiles, ragged groups, the
    chunked plan at few queries a rank, zero-weight padding): staging,
    shifts, each sweep's head and the golden step bitwise; float64
    entropies within 1e-12 (another order of the sums), float32 within
    2e-5 (ex2.approx against exp2)."""
    from kde_tpu_torch.ops import sharded_loo as sl
    n, zero = K7_CASES[name]
    pts, w, bracket, ranks = _k7_shards(cuda, n, getattr(torch, dtype), zero,
                                        ranks=int(name.split("x")[0]))
    l0 = sl.LAUNCHES
    pairs = _k7_phase_pairs(pts, w, bracket, ranks)
    torch.cuda.synchronize()
    assert sl.LAUNCHES > l0
    rtol = 1e-12 if dtype == "float64" else 2e-5
    for what, got, want in pairs:
        exact = not what.startswith("sweep ent")
        torch.testing.assert_close(got, want, rtol=0 if exact else rtol,
                                   atol=0, equal_nan=True, msg=what)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_loo_plans_agree(cuda, dtype, monkeypatch):
    """The fused sweep on its own plan and on plans forced to cut the
    columns into 2, 3 and 7 chunks: each plan's entropies bitwise the same
    over repeated launches, the plans' within 1e-12 (float64) or 2e-5 of
    each other, and the heads' state bitwise equal."""
    from kde_tpu_torch.ops import sharded_loo as sl
    pts, w, bracket, _ = _k7_shards(cuda, 7000, getattr(torch, dtype), 9)
    plan = sl.sweep_plan
    outs = {}
    for tiles in (None, 4, 3, 1):
        if tiles is not None:
            monkeypatch.setattr(sl, "sweep_plan", lambda mq, n_pad, rows, sms,
                                t=tiles: plan(mq, n_pad, rows, sms)._replace(
                                    chunks=-(-n_pad // (t * sl.TILE)),
                                    tiles=t))
        sw = _k7_rank(pts, w, bracket, 0, len(pts))
        runs = []
        for _ in range(2):
            sl.sweep(sw, 0)
            sl.sweep(sw, 1)
            runs.append((sw.ent_v[0].clone(), sw.ent_v[1].clone(),
                         sw.st[1].clone(), sw.fl[1].clone()))
        for a, b in zip(*runs):
            assert torch.equal(a, b)
        outs[tiles] = runs[0]
    rtol = 1e-12 if dtype == "float64" else 2e-5
    for tiles, got in outs.items():
        for k in (0, 1):
            torch.testing.assert_close(got[k], outs[None][k], rtol=rtol,
                                       atol=0, msg=str(tiles))
        torch.testing.assert_close(got[3], outs[None][3], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ksize_sharded_on_k7_without_a_host_sync(nccl_world, cuda, dtype,
                                                 monkeypatch):
    """ksize_bandwidths_sharded of CUDA tensors on a one-rank NCCL mesh:
    only K7 (no twin stage, no K4 or K1 launch: stage, nn_shift, one a
    sweep and the closing step), one all-reduce a sweep issued, no host
    sync but the lagged flag reads (each one sweep behind
    the sweep just issued), bitwise the same on repeat, and the picks of
    the twin search on CPU copies (float64 within 1e-10, float32 within
    the final bracket, 2 tol relative)."""
    from kde_tpu_torch import parallel as par
    from kde_tpu_torch.ops import loo_search, sharded_loo as sl, tiled_eval
    dt = getattr(torch, dtype)
    pts, w, bracket, _ = _k7_shards(cuda, 4000, dt, zero=50)
    mesh = par.make_mesh_2d((1, 1))
    first = par.ksize_bandwidths_sharded(mesh, pts, w)      # warm
    torch.cuda.synchronize()
    reads = []
    read = sl._read_flag

    def lagged(flags, events, k):
        reads.append(len(events) - 1 - k)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return read(flags, events, k)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    monkeypatch.setattr(sl, "_read_flag", lagged)
    issued = []
    all_reduce = torch.distributed.all_reduce

    def counted(*a, **kw):
        issued.append(1)
        return all_reduce(*a, **kw)
    monkeypatch.setattr(torch.distributed, "all_reduce", counted)
    counts = (sl.LAUNCHES, sl.TWIN_STAGES, loo_search.LAUNCHES,
              tiled_eval.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = par.ksize_bandwidths_sharded(mesh, pts, w)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    monkeypatch.setattr(torch.distributed, "all_reduce", all_reduce)
    sweeps = sl.LAST["sweeps"]
    assert sl.LAUNCHES - counts[0] == 3 + sweeps
    assert (sl.TWIN_STAGES, loo_search.LAUNCHES,
            tiled_eval.LAUNCHES) == counts[1:]
    assert len(issued) == sweeps
    waits = sweeps - sl.FLAG_LAG - (sl.LAST["stop"] == "max_iters")
    assert reads and min(reads) >= 1 and len(reads) == waits
    assert torch.equal(got, first)
    for _ in range(3):
        assert torch.equal(par.ksize_bandwidths_sharded(mesh, pts, w), got)
    wn = w / w.sum()                     # as ksize_bandwidths_sharded has it
    on_cpu = [t.cpu() for t in (pts, wn, pts, wn, *bracket)]
    twin = sl.search(*on_cpu, tol=K4_TOL).to(cuda)
    rel = float(((got.double() - twin.double()).abs()
                 / twin.double().abs()).max())
    assert rel <= (1e-10 if dtype == "float64" else 2 * K4_TOL)


# ---------------------------------------------------------------------------
# K8 tree_build: the device plan's tree, moments and level arrays against
# the twin (ops/device_plan.py's eager build) on the card, bit for bit
# ---------------------------------------------------------------------------

K8_NS = (1, 2, 3, 7, 33, 257, 1000, 20000, 100000)
K8_DIMS = (1, 2, 3, 8)


def _k8_inputs(cuda, b, n, d, dtype, seed, ties=False):
    """``b`` sets of ``n`` points in ``d`` dims; with ``ties`` the
    coordinates are rounded to halves and a quarter of the points repeat
    the first.  Each dim is scaled apart (sqrt(k + 1) (1 + 0.07 k)), so two
    dims' spreads tie only where the points do: the bitwise cases.  Spreads
    that tie in real arithmetic are left to the float64 sums' rounding,
    whose order differs between the kernel and the twin;
    ``test_tree_build_equal_spread_ties`` holds those."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, n, d))
    if ties:
        pts = np.round(pts * 2) / 2
        pts[:, n // 3:n // 3 + n // 4] = pts[:, :1]
    pts = pts * np.sqrt(np.arange(1, d + 1)) * (1 + 0.07 * np.arange(d))
    var = np.abs(rng.normal(size=(b, n, d))) + 0.1
    w = rng.uniform(0.5, 1.5, size=(b, n))
    w /= w.sum(axis=1, keepdims=True)
    return [torch.as_tensor(x, dtype=dtype, device=cuda)
            for x in (pts, var, w)]


def _k8_stats(points, var, w):
    """K8's tree of one density over ``[B, n, ...]`` inputs, as
    ``device_tree_stats`` returns it."""
    from kde_tpu_torch.ops import tree_build
    out = tree_build.launch([(points, var, w)], points.dtype,
                            2 * points.shape[1])
    return tuple(out[k][:, 0] for k in ("t_mean", "t_bw", "wts", "t_perm"))


def _k8_equal(got, want):
    for name, g, x in zip(("means", "bw", "wts", "perm"), got, want):
        assert g.shape == x.shape and g.dtype == x.dtype, name
        assert torch.equal(g, x), (name, int((g != x).sum()))


def _plan_names():
    return ("t_mean", "t_bw", "lvl_mean", "lvl_bw", "lvl_logw", "lvl_perm",
            "lvl_uniform")


def _arrays_equal(got, want):
    for name, g, x in zip(_plan_names(), got, want):
        assert g.shape == x.shape and g.dtype == x.dtype, name
        assert torch.equal(g, x), (name, int((g != x).sum()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("d", K8_DIMS)
@pytest.mark.parametrize("n", K8_NS)
def test_tree_build_matches_twin(cuda, n, d, dtype):
    """One launch plan's kernels against the eager twin on the card: the
    leaf permutation and the node statistics bit for bit (N = 100,000
    takes the multi-block route for its top depths)."""
    from kde_tpu_torch.ops import device_plan, tree_build
    args = _k8_inputs(cuda, 1, n, d, dtype, n + 10 * d)
    before = tree_build.LAUNCHES
    got = _k8_stats(*args)
    torch.cuda.synchronize()
    k0 = sum(r["route"] == "multi"
             for r in tree_build.launch_plan(n, d, dtype))
    assert tree_build.LAUNCHES - before == 3 * k0 + 1 + (k0 > 0)
    _k8_equal(got, device_plan.device_tree_stats(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n,d", [(7, 2), (257, 3), (1000, 2), (20000, 3),
                                 (100000, 2)])
def test_tree_build_ties_and_duplicates(cuda, n, d, dtype):
    """Tied coordinates and duplicated points: the stable order (ties by
    the current position) is the twin's."""
    from kde_tpu_torch.ops import device_plan
    args = _k8_inputs(cuda, 1, n, d, dtype, n + 7, ties=True)
    _k8_equal(_k8_stats(*args), device_plan.device_tree_stats(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n,d", [(7, 2), (257, 2), (1000, 3), (20000, 2),
                                 (20000, 3), (100000, 2)])
def test_tree_build_equal_spread_ties(cuda, n, d, dtype):
    """Dims whose spreads tie in real arithmetic (each dim a permutation of
    one column of rounded halves, a quarter of it repeated): the float64
    sums' rounding picks the split dim, in another order in K8 than in the
    twin, so the two trees may differ.  Each is held to a median split
    whose every split dim's spread lies within rtol 1e-12 of the widest,
    and K8's statistics equal, bit for bit, the twin's moment sweep over
    K8's own leaf order."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    from median_split import equal_spread_points, median_split_violations
    from kde_tpu_torch.ops import device_plan
    rng = np.random.default_rng(n + 3 * d)
    pts = equal_spread_points(rng, n, d)[None]
    var = np.abs(rng.normal(size=(1, n, d))) + 0.1
    w = np.full((1, n), 1.0 / n)
    args = [torch.as_tensor(x, dtype=dtype, device=cuda)
            for x in (pts, var, w)]
    got = _k8_stats(*args)
    twin = device_plan.device_tree_stats(*args)
    coords = args[0][0].cpu().numpy()
    assert median_split_violations(coords, got[3][0].cpu().numpy()) == []
    assert median_split_violations(coords, twin[3][0].cpu().numpy()) == []
    _k8_equal(got, device_plan._tree_moments(*args, got[3][:, n:]))


@pytest.mark.parametrize("k0", [0, 1, 2, 3, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_tree_build_multi_route_at_every_depth(cuda, dtype, k0):
    """The subtree launch taking over at other depths of 2 x 20,000 points,
    with other chunks (the private launcher chip_smoke.py --k8-routes
    times; at depth 0 one block a density), builds the same tree as the
    launch plan's route; a subtree wider than a block's shared memory (a
    whole 20,000-point float64 slice at 12 bytes a key) is refused."""
    from kde_tpu_torch.ops import tree_build
    ins = [tuple(_k8_inputs(cuda, 2, 20000, 3, dtype, 40 + j, ties=j == 1))
           for j in range(2)]
    one = tree_build.launch(ins, dtype, 40000)
    depths = [k0, max(k0 - 1, 0)]
    item = torch.empty((), dtype=dtype).element_size()
    if tree_build.subtree_smem(20000 >> min(depths),
                               item) > tree_build.SMEM_MAX_BYTES:
        with pytest.raises(ValueError):
            tree_build._launch_routes(ins, dtype, 40000, None, depths,
                                      tree_build.CHUNK)
        return
    for chunk in (1024, tree_build.CHUNK):
        over = tree_build._launch_routes(ins, dtype, 40000, None, depths,
                                         chunk)
        for key in ("t_mean", "t_bw", "t_logw", "t_perm", "wts"):
            assert torch.equal(one[key], over[key]), (key, chunk)


def _k8_sets(cuda, rng, b, ns, dtype=torch.float32):
    import kde_tpu_torch as kt
    return [[kt.kde(torch.as_tensor(rng.normal(size=(2, n)) + 0.25 * i,
                                    dtype=dtype, device=cuda),
                    list(rng.uniform(0.1, 0.4, 2))) for n in ns]
            for i in range(b)]


@pytest.mark.parametrize("b", [1, 6])
@pytest.mark.parametrize("ns", [(1000, 1000), (1000, 700), (20000, 3)])
def test_plan_arrays_match_twin_route(cuda, b, ns):
    """``b`` sets of two densities: the slot arrays and the level arrays of
    one build against the twin route's eager assembly, bit for bit."""
    from kde_tpu_torch.ops import device_plan
    from kde_tpu_torch.ops.balltree import n_levels
    sets = _k8_sets(cuda, np.random.default_rng(sum(ns) + b), b, ns)
    n_lv = n_levels(4000, ns)
    _arrays_equal(
        device_plan._kernel_arrays(sets, ns, n_lv, torch.float32),
        device_plan._eager_arrays(sets, ns, n_lv, torch.float32))


@pytest.mark.parametrize("dn,b", [(17, 1), (33, 2)])
def test_plan_of_more_densities_than_a_launch_group(cuda, dn, b):
    """A plan of more than MAX_DENS densities (a belief-propagation node
    with many incoming messages) takes one group of launches per MAX_DENS
    densities and equals the twin route's, bit for bit; so does a ``*`` of
    17 device-resident densities."""
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import device_plan, gibbs, tree_build
    from kde_tpu_torch.ops.balltree import n_levels
    rng = np.random.default_rng(dn)
    ns = tuple(int(n) for n in rng.integers(200, 1500, dn))
    sets = _k8_sets(cuda, rng, b, ns)
    n_lv = n_levels(1000, ns)
    before = tree_build.LAUNCHES
    got = device_plan._kernel_arrays(sets, ns, n_lv, torch.float32)
    multi = [sum(r["route"] == "multi"
                 for r in tree_build.launch_plan(n, 2, torch.float32))
             for n in ns]
    groups = [max(multi[g:g + tree_build.MAX_DENS])
              for g in range(0, dn, tree_build.MAX_DENS)]
    assert tree_build.LAUNCHES - before == 1 + sum(
        3 * k + 1 + (k > 0) for k in groups)
    _arrays_equal(got, device_plan._eager_arrays(sets, ns, n_lv,
                                                 torch.float32))
    if dn == 17:
        before = tree_build.LAUNCHES
        out = kt.product(sets[0], key=3)
        assert tree_build.LAUNCHES > before
        assert out.points.is_cuda and bool(torch.isfinite(out.points).all())
        gibbs._plan_cache.clear()


def _twin_route(monkeypatch):
    from kde_tpu_torch.ops import device_plan
    monkeypatch.setattr(device_plan, "_kernel_arrays",
                        device_plan._eager_arrays)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_device_product_plan_equals_twin_route(cuda, monkeypatch, dtype):
    """All nine values of a DeviceProductPlan of 2 x 20,000 3-D points (the
    star cells' shape) equal the twin route's."""
    from kde_tpu_torch.ops import device_plan
    rng = np.random.default_rng(9)
    import kde_tpu_torch as kt
    dens = [kt.kde(torch.as_tensor(rng.normal(size=(3, 20000)) + 0.5 * j,
                                   dtype=dtype, device=cuda), [0.2])
            for j in range(2)]
    got = device_plan.DeviceProductPlan(dens, 20000, dtype)
    _twin_route(monkeypatch)
    want = device_plan.DeviceProductPlan(dens, 20000, dtype)
    assert (got.offsets, got.n_levels) == (want.offsets, want.n_levels)
    for name in _plan_names():
        g, x = getattr(got, name), getattr(want, name)
        assert g.dtype == x.dtype and torch.equal(g, x), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_plan_workspace_matches_the_allocator(cuda, dtype):
    """The workspace the sizing model counts for a 2 x 20,000 plan on the
    card (``device_plan.build_bytes``) is what the allocator's peak shows
    beyond the plan's own tensors, to its 512-byte rounding."""
    from kde_tpu_torch.ops import device_plan
    from kde_tpu_torch.ops.balltree import n_levels
    ns = (20000, 20000)
    sets = _k8_sets(cuda, np.random.default_rng(14), 1, ns, dtype)
    n_lv = n_levels(20000, ns)
    device_plan._level_table.cache_clear()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    out = device_plan.batched_device_plans(sets, 20000, dtype)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - base
    kept = sum(t.numel() * t.element_size()
               for t in out if isinstance(t, torch.Tensor))
    nodes = out[2].shape[2] * len(ns)
    item = torch.empty((), dtype=dtype).element_size()
    counted = device_plan.build_bytes(ns, 2, item, nodes, cuda)
    assert abs(peak - kept - counted) <= 512 * 16, (peak - kept, counted)


def test_keyed_product_on_device_plan_equals_twin_route(cuda, monkeypatch):
    """A keyed ``*`` of device-resident beliefs (the star cells' path)
    launches K8 and draws what the twin route's plan draws."""
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import gibbs, tree_build
    rng = np.random.default_rng(10)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=cuda)
    p, q = (kt.kde(f32(rng.normal(size=(2, 5000)) + 0.5 * j), [0.2])
            for j in range(2))
    before = tree_build.LAUNCHES
    got = kt.product([p, q], key=11)
    assert tree_build.LAUNCHES > before
    gibbs._plan_cache.clear()
    _twin_route(monkeypatch)
    want = kt.product([p, q], key=11)
    assert torch.equal(got.points, want.points)
    assert torch.equal(got.bw, want.bw)


def test_batched_sampler_launches_tree_build(cuda):
    """BatchedProductSampler's build and refresh of device-resident sets go
    through K8."""
    import kde_tpu_torch as kt
    from kde_tpu_torch.ops import tree_build
    rng = np.random.default_rng(12)
    before = tree_build.LAUNCHES
    sampler = kt.BatchedProductSampler(_cuda_sets(cuda, rng, 6, 1000),
                                       n_out=1000, n_iter=3)
    built = tree_build.LAUNCHES
    assert built > before
    sampler.refresh(_cuda_sets(cuda, rng, 6, 1000))
    assert tree_build.LAUNCHES > built
    pts, _ = sampler.sample(3)
    assert bool(torch.isfinite(pts).all())


def test_plan_build_has_no_sync_and_few_launches(cuda):
    """Once the level table is cached, a 2 x 20,000 plan build neither
    synchronises nor copies to the card, and makes the launch plan's
    launches and no other (the profiler's count of launch calls): three a
    depth on the multi-block route, the subtree launch, the moments above
    it and the level launch."""
    import kde_tpu_torch as kt
    from torch.profiler import ProfilerActivity, profile
    from kde_tpu_torch.ops import device_plan, tree_build
    rng = np.random.default_rng(13)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=cuda)
    dens = [kt.kde(f32(rng.normal(size=(2, 20000))), [0.2]) for _ in range(2)]
    device_plan.DeviceProductPlan(dens, 20000, torch.float32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            device_plan.DeviceProductPlan(dens, 20000, torch.float32)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    launches = sum(("LaunchKernel" in s) for s in names)
    copies = sum(("Memcpy" in s and "HtoD" in s) for s in names)
    multi = sum(r["route"] == "multi"
                for r in tree_build.launch_plan(20000, 2, torch.float32))
    assert launches == 3 * multi + 3, launches
    assert copies == 0, copies


def test_tree_build_refuses_bad_inputs(cuda):
    """Mixed devices, other dtypes, bad shapes, strided inputs and an empty
    plan raise; nothing falls back to the twin."""
    from kde_tpu_torch.ops import tree_build
    pts, var, w = _k8_inputs(cuda, 1, 50, 2, torch.float32, 1)
    launch = lambda p, v, x, dt=torch.float32: tree_build.launch(
        [(p, v, x)], dt, 100)
    with pytest.raises(ValueError):
        launch(pts, var.cpu(), w)
    with pytest.raises(TypeError):
        launch(pts.half(), var.half(), w.half(), torch.float16)
    with pytest.raises(TypeError):
        launch(pts, var.double(), w)
    with pytest.raises(TypeError):
        launch(pts.int(), var.int(), w.int(), torch.int32)
    with pytest.raises(ValueError):
        launch(pts, var[:, :40], w)
    with pytest.raises(ValueError):
        launch(pts, var, w[:, :40])
    with pytest.raises(ValueError):
        launch(pts[0, :, 0], var[0, :, 0], w[0])
    with pytest.raises(ValueError):
        launch(pts.transpose(1, 2).contiguous().transpose(1, 2), var, w)
    with pytest.raises(ValueError):
        tree_build.launch([], torch.float32, 100)