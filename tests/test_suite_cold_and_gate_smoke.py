"""Smoke lanes for the suite's cold-process mode and the regression gate.

The reference exercises its perf harness end-to-end (tools/check_performance.py
re-runs tools/suite.py against its benchmarks/inputs/results.json); these lanes do
the same for this repo's harness on the cheapest scenario so a mechanism break
(subprocess driver, history merge, gate exit code) fails in the default suite
rather than on the next manual perf run.  Thresholds are deliberately huge:
the lanes assert the MACHINERY, never wall-clock, so they stay green on a
loaded CI host.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

# the dented_cube lane's final energy on the host CPU in f64, and a best
# time of that lane on a CPU host, as a suite history would record them
DENTED_CUBE = {"best_seconds": 0.0495, "energy": 4.957374763980568, "platform": "cpu"}


def _suite():
    import suite

    return suite


def test_run_cold_records_lane(tmp_path, monkeypatch):
    suite = _suite()
    monkeypatch.setattr(suite, "COLD_RESULTS", tmp_path / "cold.json")
    out = suite.run_cold(["dented_cube"], "cpu", 1)
    assert "dented_cube" in out
    rec = out["dented_cube"]
    assert rec["cold_seconds"] > 0
    # the cold subprocess must converge to the lane's recorded energy
    assert abs(rec["energy"] - DENTED_CUBE["energy"]) <= 1e-8 * max(
        1.0, abs(DENTED_CUBE["energy"])
    )
    # and the record must have been merged to the (patched) history file
    on_disk = json.loads((tmp_path / "cold.json").read_text())
    assert on_disk["dented_cube"]["energy"] == rec["energy"]


def test_check_performance_gate_passes_on_recorded_lane(capsys, tmp_path, monkeypatch):
    """The --check gate re-runs a lane without updating history and exits 0
    when within threshold (50x: asserts mechanism, not wall-clock)."""
    suite = _suite()
    results = tmp_path / "results.json"
    results.write_text(json.dumps({"dented_cube": DENTED_CUBE}))
    monkeypatch.setattr(suite, "RESULTS", results)
    rc = suite.main(
        [
            "dented_cube",
            "--check",
            "--no-update",
            "--threshold",
            "50",
            "--platform",
            "cpu",
            "--runs",
            "1",
        ]
    )
    assert rc == 0
    # history must be untouched by --no-update
    assert json.loads(results.read_text()) == {"dented_cube": DENTED_CUBE}
