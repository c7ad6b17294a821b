"""Root conftest: tests run on the CPU with 8 virtual devices.

Tests exercise the same code paths as the GPU runs on XLA's CPU backend,
with 8 virtual devices so the sharding logic is covered without a
multi-card machine.  ``JAX_PLATFORMS`` defaults to ``cpu``; tests marked
``gpu`` need a card (the ``gpu_device`` fixture skips them otherwise) and
run with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` on a
GPU machine.  ``chip_smoke.py`` is the on-card check of the main path.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on a GPU machine)")
