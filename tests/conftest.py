"""Test configuration: the CPU with 8 virtual devices (unless JAX_PLATFORMS
names another platform), so multi-device sharding logic is exercised without
GPUs (SURVEY.md section 4, item 5).

The platform is set through jax.config and the host device-count flag lands
before the first backend initialization. Tests that need the GPU take the
``gpu`` fixture: it skips them, with a reason, at run time elsewhere."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped elsewhere (decided in the "
                   "``gpu`` fixture at run time, never at import)")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU. Tests using it carry the
    ``gpu`` marker; on a card run them with
    ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu -p no:xdist``."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX default backend is "
                    f"{jax.default_backend()!r})")


@pytest.fixture(scope="session")
def test_ply_path(tmp_path_factory):
    """The 16-splat fixture scene (tests/fixture_data.py) and its
    test_vr.json, generated from a seed into a session temp dir."""
    from fixture_data import write_fixture

    return write_fixture(str(tmp_path_factory.mktemp("data")))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
