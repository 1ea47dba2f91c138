"""Test harness config: force the CPU backend with 8 virtual devices so
the multi-device sharding paths compile and run without accelerator
hardware."""
import os
import sys

# Unit tests must be hermetic and host-runnable, whatever accelerator
# the session's environment points JAX at.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# Make the repo importable when pytest is run from anywhere.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from sdvpcmdecoder_tpu.utils import jaxcache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Persistent compilation cache (JAX_COMPILATION_CACHE_DIR, else the
# checkout's .jax_cache): the trial-grid programs are expensive to
# compile on CPU.
jaxcache.enable(min_compile_secs=0.5)
