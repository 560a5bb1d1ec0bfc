"""The port's tests on the CPU (not a test).

``kde_tpu_torch`` puts densities built from NumPy, strings and files on
``config.DEVICE``, the card by default.  A test file that builds such
densities imports the autouse fixture below, so its tests ask for the CPU:

    from torch_cpu import on_cpu  # noqa: F401
"""
import pytest


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    """``config.DEVICE = "cpu"`` for the module, module-scoped fixtures
    included."""
    from kde_tpu_torch import config
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(config, "DEVICE", "cpu")
        yield
