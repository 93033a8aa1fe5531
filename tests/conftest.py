"""Test harness configuration.

Runs everything on CPU with 8 virtual devices (the standard JAX recipe for
testing `shard_map`/mesh logic without a cluster — SURVEY.md §4), with
`jax_default_device` pinned to the first CPU device.  Tests marked `gpu`
place their work on the card explicitly (tests/test_gpu_parity.py).
"""

import os

# Must be set before jax initializes its backends.
_flag = "--xla_force_host_platform_device_count=8"
if _flag not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + _flag).strip()

import jax  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    jax.config.update("jax_default_device", jax.devices("cpu")[0])


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX has none (decided here, at
    run time, so every worker collects the same tests)."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("no GPU: these tests run on the card (python chip_smoke.py)")
    return gpus[0]


@pytest.fixture
def cpu_devices():
    return jax.devices("cpu")


@pytest.fixture
def cpu_mesh8(cpu_devices):
    import numpy as np

    return jax.sharding.Mesh(np.array(cpu_devices).reshape(4, 2), ("x", "y"))
