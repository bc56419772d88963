"""Test harness: run everything on a virtual 8-device CPU mesh.

Hardware-free testing is the analog of the reference's sw_emu/hw_emu +
LOCAL_BLAZE flows (SURVEY.md §4): kernels run in the Pallas interpreter
and the multi-device sharding path on host CPU devices.  Run with
``JAX_PLATFORMS=cpu``.  Tests marked ``gpu`` need the card and skip
elsewhere; on a GPU machine run them with ``python -m pytest -m gpu tests/``.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from acc_genomics_tpu.utils.cache import enable_persistent_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)
enable_persistent_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (daemon subprocess, heavy interpret runs)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (daemon CLI, multiprocess, heavy interpret);"
        " excluded by default, enable with --runslow or RUN_SLOW=1",
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (the compiled kernels); skips "
        "elsewhere",
    )


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or os.environ.get("RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow; run with --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's first device is a GPU —
    decided here, at run time, so every worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU")
