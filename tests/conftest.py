"""Test configuration: force a virtual 8-device CPU platform before JAX init.

Multi-chip sharding tests run against the virtual mesh; numerical tests run in
float64 on CPU (the package enables jax_enable_x64 on import).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
# The AOT export cache trades a one-time export cost for fast later process
# startups; the suite creates hundreds of one-shot signatures, so keep it
# off here (tests/test_aot_cache.py exercises the cache explicitly).
os.environ.setdefault("MEMBRANE_SOLVER_AOT_CACHE", "0")
# The suite compiles fresh: warm reads of a long-lived XLA:CPU cache have
# crashed inside jax's get_executable_and_time once a few hundred
# executables had accumulated in one process (utils/xla_cache.py).
os.environ["MEMBRANE_SOLVER_COMPILE_CACHE"] = "0"
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

from pathlib import Path

import pytest

FIXTURES = Path(__file__).parent / "fixtures"
REPO_ROOT = Path(__file__).parent.parent


@pytest.fixture
def fixtures_dir() -> Path:
    return FIXTURES


def _lane_for(name: str) -> str:
    if "benchmark" in name:
        return "benchmark"
    if "e2e" in name:
        return "e2e"
    if "acceptance" in name:
        return "acceptance"
    if "regression" in name:
        return "regression"
    return "unit"


def pytest_collection_modifyitems(config, items):
    # marker lanes from filename conventions (reference tests/conftest.py:34-61)
    for item in items:
        item.add_marker(getattr(pytest.mark, _lane_for(item.fspath.basename)))
