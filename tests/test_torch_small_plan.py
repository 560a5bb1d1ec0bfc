"""What the card's LOOCV bandwidth selection (``kde_tpu_torch/ops/
host_small.py::ksize_small``) is given, on the CPU: the internal ball-tree
nodes' table uploaded once per size, and the cluster launch plan.  The
kernel itself runs only on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kde_tpu.ops import loocv as jloocv  # noqa: E402
from kde_tpu_torch import config as tconfig  # noqa: E402
from kde_tpu_torch.ops import host_small as ths  # noqa: E402
from kde_tpu_torch.ops import loocv as tloocv  # noqa: E402

H100_SMS = 132
CPU = torch.device("cpu")


def test_node_table_equals_internal_slices():
    """For n = 1..300 the cached table is the port's and kde_tpu's
    ``_internal_slices(n)``, int64, root first; a second call returns the
    same tensors (no new upload)."""
    for n in range(1, 301):
        lo, hi = ths.node_table(n, CPU)
        assert lo.dtype == hi.dtype == torch.int64
        for got, want, jwant in zip((lo, hi), tloocv._internal_slices(n),
                                    jloocv._internal_slices(n)):
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(got.numpy(), jwant)
        assert lo.numel() == max(n - 1, 0)
        if n > 1:
            assert (lo[0], hi[0]) == (0, n - 1)
        again = ths.node_table(n, CPU)
        assert again[0] is lo and again[1] is hi


@pytest.mark.parametrize("n", [1, 2, 255, 256])
def test_golden_plan_is_valid_under_the_gate(n):
    """Every (R, n) the gate admits at these n, R = 1..8: C is a power of
    two up to 16, the least one that gives a warp at most one row i a probe
    unless the cap or the SMs stop it, and the R * C blocks fit the SMs."""
    for r in range(1, 9):
        if r * n * n > tconfig.HOST_LOOCV_LIMIT:
            continue
        c = ths.golden_plan(r, n, H100_SMS)
        assert c in (1, 2, 4, 8, 16)
        assert c * r <= H100_SMS
        rows_per_block = ths.GOLDEN_ROWS_PER_BLOCK
        assert c == 1 or (c // 2) * rows_per_block < n
        if c * rows_per_block < n:
            assert c == ths.GOLDEN_MAX_CLUSTER or 2 * c * r > H100_SMS
        if n <= rows_per_block:
            assert c == 1


@pytest.mark.parametrize("r,n,sms,want", [
    (1, 100, H100_SMS, 8),         # README cfg 1: a warp a row i
    (2, 120, H100_SMS, 8),         # 2-D, N = 120
    (1, 255, H100_SMS, 16),        # the 1-D gate edge
    (2, 181, H100_SMS, 16),
    (4, 128, H100_SMS, 8),
    (64, 32, H100_SMS, 2),         # 128 blocks
    (16, 64, H100_SMS, 4),
    (1, 256, 8, 8),                # a card of 8 SMs
    (8, 90, 8, 1),
])
def test_golden_plan_cases(r, n, sms, want):
    assert ths.golden_plan(r, n, sms) == want


def test_ksize_small_on_cpu_ignores_the_cluster():
    """CPU tensors take the twin whatever cluster is asked, and launch
    nothing."""
    rng = np.random.default_rng(4)
    rows = torch.as_tensor(rng.normal(size=(2, 40)))
    w = torch.full((40,), 1.0 / 40, dtype=torch.float64)
    before = dict(ths.LAUNCHES)
    want = ths.ksize_small_ref(rows, w)
    for c in (None, 1, 16):
        torch.testing.assert_close(ths.ksize_small(rows, w, cluster=c), want,
                                   rtol=0, atol=0)
    assert ths.LAUNCHES == before


def test_ksize_small_rejects_bad_shapes():
    with pytest.raises(ValueError, match="rows"):
        ths.ksize_small(torch.zeros(3, dtype=torch.float64),
                        torch.ones(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="rows"):
        ths.ksize_small(torch.zeros(1, 3, dtype=torch.float64),
                        torch.ones(4, dtype=torch.float64))
    with pytest.raises(TypeError, match="float64"):
        ths.ksize_small(torch.zeros(1, 3), torch.ones(3))
