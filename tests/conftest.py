"""Test configuration: force the CPU backend with 8 virtual devices so
sharding/multi-device tests run anywhere (SURVEY.md §4: multi-host tests
via host-platform device-count simulation). The platform is set
programmatically before any device is touched, so the tests stay on the
CPU even where JAX would pick an accelerator."""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def fixture_points() -> np.ndarray:
    from lidar_crowd.synthetic import sample_venue
    return sample_venue()


@pytest.fixture(scope="session")
def oracle_monolith(fixture_points):
    from lidar_crowd.oracle import reference as ref
    return ref.analyze(fixture_points, variant="monolith")


@pytest.fixture(scope="session")
def oracle_modular(fixture_points):
    from lidar_crowd.oracle import reference as ref
    return ref.analyze(fixture_points, variant="modular")
