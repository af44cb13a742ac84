"""Test config: the CPU backend with 8 virtual devices (multi-device
sharding tests), x64 enabled so golden comparisons run in double
precision, and the persistent compilation cache off (tests write nothing
into the checkout).

Must run before any `import jax` in test modules — pytest imports conftest
first, so setting env vars here is sufficient.

JAX_PLATFORMS defaults to "cpu". Tests marked `gpu` take the `gpu`
fixture, which skips unless a CUDA device is visible; run them on a
machine with a card with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu
tests/`.
"""
import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu():
    """The first CUDA device; skips the test when there is none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU: run with JAX_PLATFORMS=cuda,cpu "
                    "on a machine with a card")
    return devices[0]
