"""Test harness config: run JAX on a virtual 8-device CPU mesh.

With ``JAX_PLATFORMS`` unset the suite is pinned to the CPU, where
shardings are validated on a forced 8-device host platform.  A caller that
sets ``JAX_PLATFORMS`` (e.g. ``cuda`` to run the ``gpu``-marked tests on a
card) is honoured.
"""
import os
import sys

import pytest

os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \
    " --xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_DIR = "/root/reference"


def reference_golden(name: str) -> str | None:
    """Path to a reference golden-vector file, or None when unavailable."""
    path = os.path.join(REFERENCE_DIR, "vectors", "golden", name)
    return path if os.path.exists(path) else None


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX sees none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda)")
    return devices[0]
