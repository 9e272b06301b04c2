"""Test configuration.

Tests run on the CPU unless ``JAX_PLATFORMS`` says otherwise, on a
virtual 8-device CPU mesh so the multi-device sharding paths compile and
execute without a GPU.

Tests that need the card carry the ``gpu`` marker; they skip wherever
jax's first device is not a GPU.  On a machine with one:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8").strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped on other platforms")


@pytest.fixture(autouse=True)
def _skip_gpu_tests_off_gpu(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/")
