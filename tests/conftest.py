"""Test harness: force an 8-device virtual CPU mesh.

All sharding/collective paths are exercised on 8 virtual CPU devices, so
the suite runs anywhere and never takes an accelerator.  Tests that need
the GPU carry the ``gpu`` marker and skip here; on the card, run them with
``CYMF_TEST_GPU=1 python -m pytest -m gpu tests/``, which leaves JAX on its
default (GPU) platform.
"""
import os

import pytest

ON_GPU = os.environ.get("CYMF_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu"


@pytest.fixture
def require_gpu():
    """Skip unless JAX runs on a GPU (decided per test, never at import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs the GPU: CYMF_TEST_GPU=1 python -m pytest -m gpu "
                    "tests/ on the card")
