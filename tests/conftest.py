"""Test configuration: CPU simulation of an 8-device mesh + float64.

Tier (a) of the distributed test strategy (SURVEY.md §4): the same
shard_map code runs on 8 virtual CPU devices here and on real cards in
production.  ``XLA_FLAGS`` must carry the device count before JAX starts;
the platform is pinned to the CPU with ``jax.config`` after import, which
holds even where the environment names another platform.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from poms_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# XLA:CPU compiles the deep EFT graphs in minutes; repeat runs hit the cache
enable_compile_cache()
