"""Test configuration: force the CPU backend with 8 virtual devices.

The tests run without an accelerator: JAX is pointed at its CPU platform
and given ``--xla_force_host_platform_device_count=8`` before any backend
starts (the platform config is flipped and cached backends cleared, in
case something imported JAX first). The 8-device CPU mesh lets sharding
tests validate multi-device layouts. Tests that need the GPU carry the
``gpu`` marker and skip here (see the ``gpu`` fixture).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:
    import jax.extend.backend as _jeb
    _jeb.clear_backends()
except Exception:
    pass

assert jax.devices()[0].platform == "cpu", "tests must run on CPU"
assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU. Decided when the test
    runs, never at import or collection time."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run chip_smoke.py on the card)")
