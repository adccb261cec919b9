"""Test configuration: run on a virtual 8-device CPU mesh.

Sharding tests use ``xla_force_host_platform_device_count`` per the
standard JAX recipe.  Must run before jax is imported anywhere.  Tests
marked ``gpu`` need a card and skip without one; on a machine with one run
them with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_sessionstart(session):
    assert len(jax.devices("cpu")) == 8, jax.devices("cpu")


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest tests -m gpu)")


@pytest.fixture
def mesh8():
    return jax.sharding.Mesh(np.array(jax.devices()).reshape(8), ("data",))


@pytest.fixture
def rng():
    return np.random.default_rng(215)
