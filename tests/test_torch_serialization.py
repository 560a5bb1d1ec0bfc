"""The port's serialization (``kde_tpu/serialization.py``): the
reference's string format byte for byte against the JAX package, the
literal Julia strings of tests/test_serialization_julia.py, and npz files
that load across the two packages both ways."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch_cpu import on_cpu  # noqa: E402,F401

import kde_tpu  # noqa: E402
import kde_tpu_torch as kt  # noqa: E402

F64 = torch.float64

# the literal Julia prints of tests/test_serialization_julia.py
JULIA = [
    "KDE:3:[0.75]:[1.0 2.0 3.5]",
    ("KDE:2:[0.030000000000000002, 1.0e-5]:"
     "[0.1 -2.75; -6.678899999999999e-5 30000.0]"),
    "KDE:2:[2.5e-6]:[1.0e10 -1.0e-10]",
]


def _pts(seed=0, d=2, n=40):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(d, n)) * 10.0 ** rng.uniform(-6, 6, size=(d, 1))


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("backing", ["host", "tensor"])
def test_to_string_equals_jax(d, backing):
    pts = _pts(d, d)
    bw = list(np.random.default_rng(d).uniform(0.01, 2.0, size=d))
    want = kde_tpu.to_string(kde_tpu.kde(pts, bw))
    if backing == "host":
        p = kt.kde(pts, bw, dtype=F64)
    else:
        p = kt.kde(torch.as_tensor(pts), torch.as_tensor(np.asarray(bw)))
    assert kt.to_string(p) == want


@pytest.mark.parametrize("s", JULIA)
def test_julia_literals_parse_like_jax(s):
    got, want = kt.from_string(s, dtype=F64), kde_tpu.from_string(s)
    assert (got.ndim, got.npts) == (want.ndim, want.npts)
    np.testing.assert_array_equal(got.host_points(), want.host_points())
    np.testing.assert_array_equal(got.host_bw_std(), want.host_bw_std())
    again = kt.from_string(kt.to_string(got), dtype=F64)
    np.testing.assert_array_equal(again.host_points(), got.host_points())


def test_from_string_device_dtype_and_errors():
    p = kt.from_string(JULIA[1], device="cpu", dtype=torch.float32)
    assert p.dtype == torch.float32 and p.device.type == "cpu"
    with pytest.raises(ValueError, match="not a serialized"):
        kt.from_string("XYZ:1:[1.0]:[0.0]")
    with pytest.raises(ValueError, match="dims mismatch"):
        kt.from_string("KDE:2:[0.5, 0.5]:[1.0 2.0]")


@pytest.mark.parametrize("multibw", [False, True])
def test_npz_cross_loads(tmp_path, multibw):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(2, 30))
    bw = rng.uniform(0.1, 0.5, size=(2, 30)) if multibw else [0.3, 0.2]
    w = rng.uniform(0.1, 1.0, size=30)
    jp, tp = kde_tpu.kde(pts, bw, w), kt.kde(pts, bw, w, dtype=F64)
    kde_tpu.save_kde(str(tmp_path / "j.npz"), jp)
    kt.save_kde(str(tmp_path / "t.npz"), tp)
    got = kt.load_kde(str(tmp_path / "j.npz"))
    back = kde_tpu.load_kde(str(tmp_path / "t.npz"))
    for a, b in ((got, jp), (tp, back)):
        assert a.multibandwidth == b.multibandwidth == multibw
        for f in ("points", "bw", "weights"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)))
    assert got.dtype == F64
    f32 = kt.load_kde(str(tmp_path / "j.npz"), dtype=torch.float32)
    assert f32.dtype == torch.float32
    # a tensor-backed density saves the same file
    tt = kt.KDE(tp.points, tp.bw, tp.weights, multibw)
    kt.save_kde(str(tmp_path / "tt.npz"), tt)
    np.testing.assert_array_equal(
        kt.load_kde(str(tmp_path / "tt.npz")).points.numpy(),
        tp.points.numpy())


def test_multibandwidth_string_warns():
    """The string format holds one bandwidth per dim: the port warns and
    keeps the first kernel's (the JAX package's ``to_string`` means to,
    but raises NameError; its module lacks ``import warnings``)."""
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(2, 10))
    p = kt.kde(pts, rng.uniform(0.1, 0.5, size=(2, 10)), dtype=F64)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        s = kt.to_string(p)
    assert any("first kernel's bandwidth" in str(w.message) for w in rec)
    q = kt.from_string(s, dtype=F64)
    np.testing.assert_array_equal(q.host_bw_std(),
                                  np.repeat(p.host_bw_std()[:, :1], 10, 1))
