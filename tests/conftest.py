"""Test configuration.

Tests run on CPU with a virtual 8-device mesh and x64 enabled so the host
numerics match the reference's f64 math (reference src/vectors.h:30-33);
sharding logic is exercised without accelerator hardware (SURVEY.md
section 4).  The backend is forced with jax.config.update as well as the
environment, which also holds when jax was imported before this file.

Tests marked `gpu` need an NVIDIA GPU: a fixture decides at run time and
skips them on the CPU.  The GPU path itself is checked by
`python chip_smoke.py` (see README "Testing").
"""

import os

# XLA:CPU compilation of the larger drain programs overflows the default
# 8 MB main-thread stack once enough compilations ran in one process —
# observed as deterministic mid-suite SIGSEGVs inside
# backend_compile_and_load at a consistent suite position while every
# crashing test passed standalone.  The main stack grows on demand up to
# the soft limit, so raising it at startup fixes the whole run.
import resource

try:
    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    resource.setrlimit(resource.RLIMIT_STACK, (_hard, _hard))
except (ValueError, OSError):
    pass

# harmless for subprocesses that haven't imported jax yet
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from actinon_tpu import compile_cache

compile_cache.enable()

import pytest


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip a `gpu`-marked test unless JAX's default device is a GPU
    (decided per test, never at import: every xdist worker must collect
    the same tests)."""
    if request.node.get_closest_marker("gpu") \
            and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX found "
                    f"{jax.default_backend()})")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Release compiled executables between test modules.  XLA:CPU
    segfaults inside backend_compile_and_load at a consistent point deep
    into a full-suite run (the crashing test always passes standalone;
    an unlimited stack does not help) — an accumulation bug in the
    compiler/runtime.  Dropping the executable and tracing caches at
    module boundaries keeps any single process's accumulated compile
    state bounded."""
    yield
    jax.clear_caches()
