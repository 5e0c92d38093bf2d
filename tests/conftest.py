"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device logic is tested single-process the way SURVEY.md §4
prescribes: `xla_force_host_platform_device_count=8` + CPU platform,
so sharding/collective paths execute without a multi-card host. Must
run before jax initializes.

Tests marked ``gpu`` need a CUDA card. They skip on the CPU (the
``gpu`` fixture decides at run time), and run on the card with
``MCPT_TEST_ON_GPU=1 python -m pytest -m gpu tests/`` — which is how
``chip_smoke.py`` runs them. Only that variable lets JAX leave the CPU.
"""

import os
import sys

import pytest

ON_GPU = os.environ.get("MCPT_TEST_ON_GPU") == "1"

flags = os.environ.get("XLA_FLAGS", "")
if not ON_GPU and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# A plugin may import jax before this conftest runs, in which case
# jax.config already captured the environment; update the live config
# too (an error only if a backend was already initialized, which we
# want loudly).
import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a CUDA GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU (run with MCPT_TEST_ON_GPU=1 -m gpu)")
    return jax.devices()[0]
