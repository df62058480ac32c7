"""Test configuration.

By default the tests run on the CPU with 8 virtual devices, so the
multi-device sharding paths (shard_map over a Mesh) are exercised without
accelerators.  `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` runs
the tests marked `gpu` on the card instead; elsewhere their `gpu` fixture
skips them.  jax.config.update (not the environment) sets the platform,
which works as long as no backend has been initialised yet.
"""

import os

import jax
import pytest

_PLATFORMS = os.environ.get("JAX_PLATFORMS") or "cpu"
jax.config.update("jax_platforms", _PLATFORMS)
if _PLATFORMS == "cpu":
    jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform here: {dev.platform})")
    return dev
