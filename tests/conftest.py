"""Test harness: CPU backend with 8 virtual devices + x64 enabled.

Multi-host/multi-chip logic is validated on a forced-multi-device CPU mesh
(SURVEY.md section 4); float64 gives a golden-model precision floor matching
the MATLAB reference.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# The config update below wins over a JAX_PLATFORMS set in the environment
# as long as no backend has been initialized yet.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def has_middlebury() -> bool:
    try:
        from gqmap_tpu.io.dataset import data_root

        data_root()
        return True
    except FileNotFoundError:
        return False


needs_data = pytest.mark.skipif(not has_middlebury(), reason="Middlebury data unavailable")
