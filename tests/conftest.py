"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tests run on the CPU with 8 virtual devices unless JAX_PLATFORMS says
otherwise.  Tests that need the card carry the ``gpu`` marker and take the
``gpu`` fixture, which skips them when JAX's default backend is not a GPU;
on the machine with the card run them with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX's default backend is
    not a GPU (decided here, never at import, so every xdist worker
    collects the same tests)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "tests/ -m gpu")
    return jax.devices()[0]
