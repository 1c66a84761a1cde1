"""Test config: run JAX on a virtual 8-device CPU mesh so sharding
tests exercise real multi-device paths without accelerators. Kernels
run in Pallas interpret mode; tests that need a GPU carry the `gpu`
marker and skip here."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules. Two independent
    single-process full-suite runs segfaulted inside XLA
    backend_compile at ~60%: each module compiles
    dozens of large interpret-mode programs and the cumulative
    executable footprint in one process crossed some CPU-backend
    cliff. Modules don't share program shapes, so clearing at module
    teardown costs nothing and keeps the single-process invocation
    viable; scripts/run_tests.py (one process per file) remains the
    documented full-suite entrypoint."""
    yield
    jax.clear_caches()
