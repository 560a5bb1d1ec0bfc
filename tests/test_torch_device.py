"""Where the port's entry points put a density.  NumPy, string and file
inputs go to ``kde_tpu_torch.config.DEVICE`` when the caller names no
device: the card by default, the CPU in these tests.  Without a card the
default raises torch's own error; nothing falls back to the CPU.  Tensor
inputs keep their device."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import kde_tpu_torch as kt  # noqa: E402
from kde_tpu_torch import config  # noqa: E402
from kde_tpu_torch import parallel as par  # noqa: E402
from kde_tpu_torch.ops.loocv import (ksize_bandwidths,  # noqa: E402
                                     ksize_bandwidths_device)
from torch_cpu import on_cpu  # noqa: E402,F401


def _points(n=60, d=2, seed=0):
    return np.random.default_rng(seed).normal(size=(d, n))


def _string(device=None):
    return kt.from_string(
        "KDE:3:[0.5, 0.25]:[0.0 1.0 2.0; 3.0 4.0 5.0]", device=device)


def _npz(tmp_path, device=None):
    path = str(tmp_path / "p.npz")
    kt.save_kde(path, kt.kde(_points(), [0.3], device="cpu"))
    return kt.load_kde(path, device=device)


def _from_numpy(device=None):
    return kt.kde_from_numpy(_points().T, np.full((60, 2), 0.1),
                             np.full(60, 1 / 60), False, device=device)


ENTRY_POINTS = {
    "kde": lambda tmp, **kw: kt.kde(_points(), **kw),
    "kde_loocv": lambda tmp, **kw: kt.kde(_points(), None, **kw),
    "kde_bw": lambda tmp, **kw: kt.kde(_points(), [0.2], **kw),
    "kde_from_numpy": lambda tmp, **kw: _from_numpy(**kw),
    "from_string": lambda tmp, **kw: _string(**kw),
    "load_kde": lambda tmp, **kw: _npz(tmp, **kw),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_default_device_is_config_device(name, tmp_path):
    assert config.DEVICE == "cpu"          # the tests' fixture
    k = ENTRY_POINTS[name](tmp_path)
    assert k.device.type == "cpu" and k.points.device.type == "cpu"


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_card_default_raises_without_card(name, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default lands there")
    monkeypatch.setattr(config, "DEVICE", "cuda")
    with pytest.raises((AssertionError, RuntimeError),
                       match="CUDA|cuda|GPU"):
        ENTRY_POINTS[name](tmp_path)


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_explicit_device_wins(name, tmp_path, monkeypatch):
    monkeypatch.setattr(config, "DEVICE", "cuda")
    k = ENTRY_POINTS[name](tmp_path, device="cpu")
    assert k.device.type == "cpu"


def test_ksize_bandwidths_follows_config_device(monkeypatch):
    pts = _points(n=200).T
    w = np.full(200, 1 / 200)
    bw = ksize_bandwidths(pts, w)
    assert bw.shape == (2,) and np.all(np.isfinite(bw) & (bw > 0))
    np.testing.assert_array_equal(bw, ksize_bandwidths(pts, w, device="cpu"))
    if not torch.cuda.is_available():
        monkeypatch.setattr(config, "DEVICE", "cuda")
        with pytest.raises((AssertionError, RuntimeError)):
            ksize_bandwidths(pts, w)


@pytest.mark.parametrize("fit", [False, True])
def test_tensor_input_keeps_its_device(fit, monkeypatch):
    monkeypatch.setattr(config, "DEVICE", "cuda")
    pts = torch.as_tensor(_points(n=300), dtype=torch.float64)
    k = kt.kde(pts) if fit else kt.kde(pts, [0.2])
    assert k.device.type == "cpu"
    assert kt.KDE(k.points, k.bw, k.weights).device.type == "cpu"


def test_default_device_resolves_at_call_time(monkeypatch):
    assert config.default_device() == torch.device("cpu")
    monkeypatch.setattr(config, "DEVICE", "cuda")
    assert config.default_device() == torch.device("cuda")
    assert config.default_device("cpu") == torch.device("cpu")


# The device-level and sharded LOOCV and evaluation: NumPy inputs go to
# config.DEVICE too (the sharded ones over a one-rank gloo world here).

def _loocv_inputs(as_tensor):
    rng = np.random.default_rng(1)
    x = dict(q=rng.normal(size=(8, 2)), pts=rng.normal(size=(40, 2)),
             var=np.full((40, 2), 0.3), w=np.full(40, 1 / 40))
    return {k: torch.as_tensor(v) for k, v in x.items()} if as_tensor else x


LOOCV_ENTRY_POINTS = {
    "ksize_bandwidths_device": lambda mesh, x:
        ksize_bandwidths_device(x["pts"]),
    "sharded_log_eval": lambda mesh, x:
        par.sharded_log_eval(mesh, x["q"], x["pts"], x["var"], x["w"]),
    "sharded_loo_entropy": lambda mesh, x:
        par.sharded_loo_entropy(mesh, x["pts"], x["var"], x["w"]),
    "ksize_bandwidths_sharded": lambda mesh, x:
        par.ksize_bandwidths_sharded(mesh, x["pts"], x["w"]),
}


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    import torch.distributed as dist
    store = tmp_path_factory.mktemp("world") / "store"
    par.initialize_multihost(f"file://{store}", 1, 0, backend="gloo",
                             timeout=60)
    try:
        yield par.make_mesh_2d((1, 1))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", list(LOOCV_ENTRY_POINTS))
def test_loocv_numpy_input_follows_config_device(name, mesh):
    assert config.DEVICE == "cpu"          # the tests' fixture
    call = LOOCV_ENTRY_POINTS[name]
    got = call(mesh, _loocv_inputs(False))
    assert got.device.type == "cpu"
    torch.testing.assert_close(got, call(mesh, _loocv_inputs(True)),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", list(LOOCV_ENTRY_POINTS))
def test_loocv_tensor_input_keeps_its_device(name, mesh, monkeypatch):
    monkeypatch.setattr(config, "DEVICE", "cuda")
    got = LOOCV_ENTRY_POINTS[name](mesh, _loocv_inputs(True))
    assert got.device.type == "cpu"


@pytest.mark.parametrize("name", list(LOOCV_ENTRY_POINTS))
def test_loocv_card_default_raises_without_card(name, mesh, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default lands there")
    monkeypatch.setattr(config, "DEVICE", "cuda")
    with pytest.raises((AssertionError, RuntimeError),
                       match="CUDA|cuda|GPU"):
        LOOCV_ENTRY_POINTS[name](mesh, _loocv_inputs(False))
