"""Test environment: a virtual 8-device CPU mesh by default.

JAX_PLATFORMS defaults to "cpu", and the host platform is split into 8
virtual devices: the mesh the sharded-path tests run on (SURVEY.md §4).

Tests marked `gpu` need the card. They take the `gpu_device` fixture,
which skips unless JAX's default device is a GPU; run them there with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
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
    """JAX's default device when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev
