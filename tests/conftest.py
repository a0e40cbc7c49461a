"""Test configuration: the CPU with 8 virtual devices, or the card.

Run as usual (``python -m pytest tests/``), the suite pins JAX to the CPU
with 8 virtual devices, so the multi-device sharding paths are testable
without hardware; tests marked ``gpu`` then skip. ``chip_smoke.py`` runs
the ``gpu``-marked tests in its own process on the card: JAX's backends
are already up by then, and this file leaves the platform alone.
"""
import os

os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import pytest  # noqa: E402
from jax._src import xla_bridge  # noqa: E402

if not xla_bridge.backends_are_initialized():
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py)")
    return jax.devices()[0]
