"""Test environment: CPU-only with 8 virtual devices (so sharding tests run
without accelerators) and float64 enabled (so gradient parity can be checked
to the 1e-5 target, as the Julia reference tests run in Float64)."""

import os

# Must happen before jax is imported anywhere.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
