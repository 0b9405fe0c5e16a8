"""Test configuration: run on CPU with 8 virtual devices.

Multi-device sharding tests execute on a virtual CPU mesh (the strategy the
reference cannot offer — it needs real MPI ranks; see SURVEY.md §4). The
platform is set through jax.config before any backend initializes; what
only a GPU can show is a phase of chip_smoke.py, not a test.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# persistent compilation cache: the transport compiles are the dominant
# test cost; cache small entries too
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.2")

import jax  # noqa: E402

from skirt9_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
enable_compile_cache()


# ---------------------------------------------------------------- slow marks
# The reference-parity / production modules dominate the
# ~40-minute full suite. They carry the `slow` marker so the inner loop is
#   python -m pytest tests/ -m "not slow"     (~5-8 minutes)
# while `python -m pytest tests/` (the CI / driver run) is unchanged.
_SLOW_MODULES = {
    "test_reference_parity", "test_frame_parity", "test_parallel_production",
    "test_domain", "test_octree", "test_refill",
    "test_physics_tail", "test_parallel",
    # round-5 re-tier (verdict item 10): the >=20s end-to-end transport
    # modules move to the slow tier so `-m "not slow"` stays under 10 min;
    # the full `pytest tests/` run is unchanged
    "test_xray", "test_xray_engine", "test_library", "test_dynamic",
    "test_nonlte", "test_tetra", "test_kinematics", "test_multiproc",
    "test_probes", "test_family_source", "test_spheroidal",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: reference-parity / production tests (>=1 min); "
        "deselect with -m 'not slow'")


def pytest_collection_modifyitems(config, items):
    import pytest as _pytest
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in _SLOW_MODULES:
            item.add_marker(_pytest.mark.slow)
