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
from kde_tpu_torch.ops.loocv import ksize_bandwidths  # noqa: E402
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
