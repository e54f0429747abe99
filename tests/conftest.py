"""Test configuration: the suite runs on the CPU with 8 virtual devices so
the multi-device sharding paths are testable without a mesh of cards
(SURVEY.md §4e); the Pallas kernels run in interpret mode there.

``JAX_PLATFORMS`` is honoured when set.  When JAX is already imported
(chip_smoke.py runs the ``gpu``-marked tests inside its own process on the
card) nothing is changed.
"""

import os
import sys

import pytest

if "jax" not in sys.modules:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if os.environ["JAX_PLATFORMS"] == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """Skip unless the default backend is a GPU: compiled Triton kernels
    have no CPU path (their arithmetic is covered here in interpret
    mode).  Run these on the card with ``python chip_smoke.py``."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run on the card through chip_smoke.py")
