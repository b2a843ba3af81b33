"""Test config: run the suite on the host CPU with 8 virtual devices.

Per SURVEY.md §4.2.5, distributed code paths (mesh-sharded BA, multi-sequence
DP) are exercised without a multi-GPU host by forcing the host platform to
expose 8 devices.  The flag must be in XLA_FLAGS before the first backend
initialisation, and the platform is pinned to the CPU even where a GPU is
present: these are the CPU tests, and ``python chip_smoke.py`` is the GPU
check.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
