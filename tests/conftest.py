"""Test configuration.

By default the suite runs on the CPU backend with an 8-device virtual mesh,
so the sharding logic is validated without several cards (reference
analog: the fake-backend discipline of test/ut/encode_ut.cpp).  Tests
marked `chip` need a GPU; they skip elsewhere and run on the card with

    JAX_PLATFORMS=cuda python -m pytest -m chip tests/
"""
import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from atracdenc_tpu.utils.compile_cache import CHECKOUT_CACHE  # noqa: E402


def _machine_tag():
    """Host CPU fingerprint (model name + flags).  XLA:CPU caches AOT
    machine code, and entries compiled on a host with other CPU features
    load with a feature-mismatch warning and then crash or give
    ulp-different floats, so the CPU test cache is keyed by the host."""
    import hashlib
    import platform
    try:
        sig = []
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "model name")) and len(sig) < 2:
                    sig.append(line.strip())
        if sig:
            return hashlib.sha1("|".join(sorted(sig)).encode()).hexdigest()[:12]
    except OSError:
        pass
    return platform.machine()


# Persistent executable cache: the golden suites are compile-dominated.
# JAX_COMPILATION_CACHE_DIR wins when set; otherwise the checkout's
# .jax_cache, with a per-host subdirectory for the XLA:CPU entries.
if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
    _cache = CHECKOUT_CACHE
    if os.environ["JAX_PLATFORMS"] == "cpu":
        _cache = os.path.join(_cache, "cpu-" + _machine_tag())
    os.environ["JAX_COMPILATION_CACHE_DIR"] = _cache
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")


@pytest.fixture
def chip():
    """The GPU a `chip` test runs on; skips when JAX has none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform}); run "
                    "JAX_PLATFORMS=cuda python -m pytest -m chip tests/")
    return dev
