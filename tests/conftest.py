"""Test configuration: CPU backend, 8 virtual devices, float64.

Tests run on an 8-device virtual CPU mesh so multi-device sharding logic is
exercised without GPUs (chip_smoke.py --multichip runs the same path on four
cards); f64 matches the reference's PETSc tolerances. Tests that need a GPU
carry the `chip` marker and skip here.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from pathlib import Path  # noqa: E402

import pytest  # noqa: E402

# File-level quick/slow split: `pytest -m quick` is the < 3-minute commit
# gate; the slow files (8-device shard_map compiles, full MG solves) stay
# in the full round gate. See pytest.ini for the marker registry.
_SLOW_FILES = {
    "test_slab.py",
    "test_distributed.py",
    "test_solve_mms.py",
    "test_baselines.py",
    "test_incomp.py",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        name = Path(str(item.fspath)).name
        item.add_marker(
            pytest.mark.slow if name in _SLOW_FILES else pytest.mark.quick
        )
