"""Test configuration.

Tests run on a *virtual 8-device CPU mesh* (the "fake cluster" of SURVEY.md
§4): sharding/collective code paths compile and execute without a GPU.
The platform is forced through ``jax.config`` (not only the environment),
and XLA_FLAGS is set before the CPU backend first initializes.

``TPULP_TEST_DEVICE=1`` leaves the platform to JAX instead: ``chip_smoke.py``
sets it to run the ``gpu``-marked tests on the card, in its own process.
"""

import os

ON_DEVICE = os.environ.get("TPULP_TEST_DEVICE") == "1"

if not ON_DEVICE:
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

if not ON_DEVICE:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (runs executables compiled for the "
        "card; skipped on a CPU-only machine)")
    config.addinivalue_line(
        "markers", "slow: multi-process / long-running integration tests")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none. Decided at
    run time, never at import, so every xdist worker collects one list."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {devs[0].platform}")
    return devs[0]
