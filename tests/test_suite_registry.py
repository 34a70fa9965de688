"""Suite-lane registry consistency + lane report schemas.

Pins the tooling contract the perf record depends on (reference analog:
tools/suite.py's scenario table at reference tools/suite.py:29-44).  The
flat_disk lane regression here (report nesting) shipped broken once —
run_flat_disk_tilt_mass_mode read report["mesh"] instead of
report["metrics"]["mesh"] and every suite invocation of the lane crashed.
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))


def _suite():
    import suite

    return suite


def test_every_recorded_lane_is_a_known_scenario():
    suite = _suite()
    known = set(suite.SCENARIOS) | set(suite.RUNNER_SCENARIOS)
    history = suite.load_history()  # empty until a run records a lane
    unknown = set(history) - known
    assert not unknown, f"results.json has orphaned lanes: {sorted(unknown)}"


def test_runner_scenarios_are_callables_with_docstrings():
    suite = _suite()
    for name, fn in suite.RUNNER_SCENARIOS.items():
        assert callable(fn), name
        assert fn.__doc__, f"{name} lane has no reference citation docstring"


def test_all_reference_benchmark_files_have_a_lane():
    """Every reference benchmarks/benchmark_*.py maps to a timed lane."""
    suite = _suite()
    ref_bench = suite.REF_ROOT / "benchmarks"
    if not ref_bench.exists():
        import pytest

        pytest.skip("reference not mounted")
    # file-stem -> repo lane name (merged lanes listed explicitly)
    mapping = {
        "benchmark_bending": "bending_analytic",
        "benchmark_cap": "spherical_cap",
        "benchmark_catenoid": "catenoid",
        "benchmark_cube_good": "cube",
        "benchmark_dented_cube": "dented_cube",
        "benchmark_flat_disk_tilt_mass_mode": "flat_disk_tilt_mass_mode",
        "benchmark_kozlov_1disk_3d_induction_quick": "kozlov_induction_quick",
        "benchmark_kozlov_1disk_3d_profile_hard_rim": "kozlov_hard_rim_bench",
        "benchmark_kozlov_1disk_3d_profile_hard_rim_free_disk":
            "kozlov_hard_rim_free_disk_bench",
        "benchmark_kozlov_1disk_3d_profile_hard_rim_free_disk_light":
            "kozlov_free_disk_light",
        "benchmark_kozlov_1disk_3d_tensionless": "kozlov_tensionless",
        "benchmark_kozlov_annulus_decay_length": "annulus_decay_length",
        # same macro + same mesh as the free-disk light benchmark
        "benchmark_profile_relax_light": "kozlov_free_disk_light",
        "benchmark_square_to_circle": "square_to_circle",
        "benchmark_tilt_relaxation": "tilt_relaxation",
        "benchmark_two_disks_sphere": "two_disks_sphere",
        "benchmark_volume_optimization": "volume_optimization",
    }
    known = set(suite.SCENARIOS) | set(suite.RUNNER_SCENARIOS)
    stems = sorted(p.stem for p in ref_bench.glob("benchmark_*.py"))
    unmapped = [s for s in stems if s not in mapping]
    assert not unmapped, f"reference benchmarks with no lane mapping: {unmapped}"
    bad = {s: lane for s, lane in mapping.items() if lane not in known}
    assert not bad, f"mapping points at unknown lanes: {bad}"


def test_flat_disk_report_schema_has_nested_mesh_energy():
    """The reproducer's report keeps mesh metrics under metrics.mesh —
    the path run_flat_disk_tilt_mass_mode reads (suite.py) and the path
    compare_to_baseline walks (reproduce_flat_disk_one_leaflet.py:411)."""
    from reproduce_flat_disk_one_leaflet import run_benchmark

    report = run_benchmark(refine_level=1)
    assert "metrics" in report and "mesh" in report["metrics"]
    assert isinstance(float(report["metrics"]["mesh"]["total_energy"]), float)
    assert "mesh" not in report, "top-level 'mesh' would shadow metrics.mesh"
