"""Test configuration: CPU backend with 8 virtual devices, x64 enabled.

Multi-device sharding tests run on a fake 8-device CPU mesh
(``xla_force_host_platform_device_count``), the standard JAX substitute for
real multi-device hardware. complex128 paths need x64.

Tests marked ``gpu`` need the card and skip elsewhere. They run on a GPU
machine with the platform left to JAX:

    NUFFT_GPU_TESTS=1 python -m pytest tests/test_gpu.py -m gpu
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8")
_ON_CARD = os.environ.get("NUFFT_GPU_TESTS") == "1"
if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere")
    config.addinivalue_line("markers", "slow: long-running test")


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default device is a GPU (decided
    when the test runs, never at import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with NUFFT_GPU_TESTS=1 on a card)")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def random_complex(rng, shape, dtype):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def random_points(rng, shape, dtype, low=-np.pi, high=np.pi):
    return rng.uniform(low, high, shape).astype(dtype)
