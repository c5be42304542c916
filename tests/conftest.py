"""Test configuration.

Tests run on CPU with a virtual 8-device mesh so multi-device sharding
is exercised without accelerator hardware, and with float64 enabled so
the device tracer can be validated against the float64 oracle at tight
tolerances. The GPU's own check is ``python chip_smoke.py``.
"""
import os

# Must be set before jax is imported anywhere.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)
