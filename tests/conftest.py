"""Test harness config.

Tests run on CPU with 8 virtual devices (the standard JAX fake-backend
trick, SURVEY.md §4) so mesh/collective/sharding tests exercise real
multi-device code paths without accelerator hardware. The platform is
also pinned through jax.config after import, so a pre-set
JAX_PLATFORMS cannot move the tests off the CPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0x5D12)
