"""Test configuration: run everything on a virtual 8-device CPU mesh.

The CPU backend is forced via jax.config before any computation, so the
tests run the same on a machine with a GPU. XLA_FLAGS must be set before
the CPU client is created (SURVEY.md §4: multi-host tests run on CPU via
--xla_force_host_platform_device_count). Tests that need the GPU carry
the ``gpu`` marker and the ``gpu`` fixture: they skip on the CPU and run
on the card with ``python -m pytest tests -m gpu -n 0``.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from dbot_ros_tpu.utils.compile_cache import configure_compile_cache  # noqa: E402,E501

jax.config.update("jax_threefry_partitionable", True)
configure_compile_cache()


def pytest_configure(config):
    # `-m gpu` (on the card) keeps JAX's default backend; every other run
    # is forced onto the virtual CPU mesh before any computation.
    if config.getoption("markexpr") != "gpu":
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import: every xdist worker must collect the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run python chip_smoke.py on the card")
