"""Test configuration.

By default the suite runs on the CPU, on a virtual 8-device mesh, with
x64 enabled for parity with the reference's Float64 defaults. ``--gpu``
is the on-chip run: JAX keeps its GPU, and the tests marked ``gpu`` run
there (without the option they skip; with it, a missing GPU fails them).
"""
import os

import pytest


def pytest_addoption(parser):
    parser.addoption("--gpu", action="store_true", default=False,
                     help="run on the GPU, including the tests marked gpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (run with --gpu on the card)")
    if not config.getoption("--gpu"):
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    if not config.getoption("--gpu"):
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Tests marked ``gpu`` need the card: skip them in the CPU run; in
    the ``--gpu`` run, fail them if JAX finds no GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if not request.config.getoption("--gpu"):
        pytest.skip("needs an NVIDIA GPU; run with --gpu on the card")
    import jax
    platform = jax.devices()[0].platform
    assert platform == "gpu", f"--gpu run, but JAX's default device is {platform}"
