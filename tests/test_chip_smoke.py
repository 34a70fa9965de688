"""Rehearsal of chip_smoke.py on the host CPU.

The phases run here at a small size on CPU devices (the suite's virtual
CPU devices stand in for "GPU" and "host"); the script itself must refuse
to report a result when there is no GPU.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_main_exits_nonzero_without_gpu(capsys, monkeypatch):
    monkeypatch.setattr(chip_smoke, "_nvidia_smi", lambda: None)
    monkeypatch.setattr(chip_smoke, "_run_child", _no_child)
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def _no_child(*a, **k):
    raise AssertionError("no child may start without a GPU")


CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def _fake_children(f32_offset):
    """Child results as the f64 and f32 children report them; the f32
    energies sit ``f32_offset`` (relative) off the f64 ones."""
    lanes = {"small": [3.0, 2.5, 2.25], "L3": [40.0, 39.0]}

    def run_child(role, out_dir, env_extra=None):
        scale = 1.0 + (f32_offset if role == "f32" else 0.0)
        return {
            "device": DEVICE,
            "lanes": {k: {"energies": [scale * e for e in v]} for k, v in lanes.items()},
        }

    return run_child


@pytest.mark.parametrize("f32_offset,ok", [(0.0, True), (5e-4, True), (2e-3, False)])
def test_main_judges_f32_against_f64(f32_offset, ok, capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "_nvidia_smi", lambda: CARD)
    monkeypatch.setattr(chip_smoke, "_run_child", _fake_children(f32_offset))
    rc = chip_smoke.main(["--out", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert f"card: {CARD}" in lines
    if ok:
        assert rc == 0
        assert json.loads(lines[-1]) == {"ok": True, "device": DEVICE}
    else:
        assert rc != 0
        assert '"ok"' not in lines[-1]


@pytest.mark.parametrize("args", [[], ["--multi"]])
def test_main_fails_when_a_child_fails(args, capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "_nvidia_smi", lambda: CARD)
    monkeypatch.setattr(chip_smoke, "_run_child", lambda *a, **k: None)
    assert chip_smoke.main(args + ["--out", str(tmp_path)]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_child_refuses_a_cpu_default_device(capsys, tmp_path):
    assert chip_smoke.main(["--child", "f64", "--out", str(tmp_path)]) != 0
    out = capsys.readouterr().out
    assert "CHILD_RESULT" not in out


def test_script_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_phase_cli_cube_energy(tmp_path):
    energy = chip_smoke.phase_cli(tmp_path)
    assert energy == pytest.approx(chip_smoke.CUBE_ENERGY, rel=chip_smoke.CUBE_RTOL)
    assert (tmp_path / "cube_out.json").is_file()


def test_phase_lanes_compares_two_devices():
    d0, d1 = jax.devices("cpu")[:2]
    out = chip_smoke.phase_lanes(d0, d1, lanes=(("small", 0, 3, 1),))
    small = out["small"]
    assert len(small["energies"]) == 3
    assert small["gpu_vs_cpu"] <= chip_smoke.DEVICE_RTOL
    assert small["energies"][-1] < small["energies"][0]


def test_compare_trajectories_rejects_drift():
    assert chip_smoke.compare_trajectories("same", [1.0, 2.0], [1.0, 2.0], 1e-9) == 0.0
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.compare_trajectories("drift", [1.0, 2.0 + 1e-6], [1.0, 2.0], 1e-9)


def test_phase_f32_needs_x64_off():
    assert jax.config.jax_enable_x64
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.phase_f32(lanes=())
