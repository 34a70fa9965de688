"""Subprocess-level CLI end-to-end tests.

Parity: the reference's tests/test_cli_end_to_end.py spawns main.py in a
real subprocess.  The in-process recipe test (test_cube_recipe_e2e.py)
checks the physics; these check the *process*: the entry point must start,
finish and honor flags.  Every subprocess here carries a hard timeout so a
hang fails the suite instead of wedging it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).parent.parent
CUBE = REPO / "meshes" / "cube.json"


def _env(tmp_path, **overrides):
    """Subprocess env: no inherited backend pin."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    # keep the virtual 8-device flag out: these are single-process CLI runs
    env.pop("XLA_FLAGS", None)
    env.update(overrides)
    return env


def _run_cli(args, env, timeout):
    return subprocess.run(
        [sys.executable, "-m", "membrane_solver_tpu", *args],
        capture_output=True,
        text=True,
        cwd=str(REPO),
        env=env,
        timeout=timeout,
        stdin=subprocess.DEVNULL,
    )


def _small_cube(tmp_path) -> Path:
    data = json.loads(CUBE.read_text())
    data["instructions"] = ["g2"]
    path = tmp_path / "cube_short.json"
    path.write_text(json.dumps(data))
    return path


def test_cli_cpu_flag_completes_and_saves(tmp_path):
    """--cpu pins XLA:CPU and the run saves its output mesh."""
    out_path = tmp_path / "final.json"
    res = _run_cli(
        ["--non-interactive", "--cpu", "-q", "-i", str(_small_cube(tmp_path)),
         "-o", str(out_path)],
        _env(tmp_path),
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    saved = json.loads(out_path.read_text())
    assert saved["vertices"], "output mesh is empty"


def test_cli_honours_jax_platforms_env(tmp_path):
    """Without --cpu the CLI runs where JAX_PLATFORMS says; it moves no work
    to another backend on its own."""
    res = _run_cli(
        ["--non-interactive", "-q", "-i", str(_small_cube(tmp_path)),
         "--properties"],
        _env(tmp_path, JAX_PLATFORMS="cpu"),
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "falling back" not in res.stderr.lower()


def test_cli_properties_flag(tmp_path):
    res = _run_cli(
        ["--non-interactive", "--cpu", "-i", str(CUBE), "--properties"],
        _env(tmp_path),
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert "area" in res.stdout.lower() or "area" in res.stderr.lower()


def test_cli_full_cube_recipe_subprocess(tmp_path):
    """The reference's flagship recipe (meshes/cube.json, g50;r;u;V2;…;g200)
    end-to-end through the real entry point, with a hard timeout.

    Reference: /root/reference/meshes/cube.json instructions +
    tests/test_cli_end_to_end.py (subprocess main.py)."""
    out_path = tmp_path / "cube_final.json"
    res = _run_cli(
        ["--non-interactive", "--cpu", "-q", "-i", str(CUBE), "-o", str(out_path)],
        _env(tmp_path),
        timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]
    saved = json.loads(out_path.read_text())
    # post-recipe cube: two refinement passes -> hundreds of vertices
    assert len(saved["vertices"]) > 250


def test_cli_stepper_and_viz_save(tmp_path):
    """cg stepper + --viz-save render after the recipe (reference main.py
    --viz-save); --radius-of-gyration is print-and-exit like the
    reference's (main.py:505-514), so it is exercised separately."""
    out_png = tmp_path / "render.png"
    proc = _run_cli(
        [
            "--non-interactive", "--cpu", "-q",
            "-i", str(_small_cube(tmp_path)),
            "--stepper", "cg",
            "--viz-save", str(out_png),
        ],
        _env(tmp_path, MPLBACKEND="Agg"),
        timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert out_png.exists() and out_png.stat().st_size > 0


def test_cli_radius_of_gyration_prints_and_exits(tmp_path):
    proc = _run_cli(
        ["--non-interactive", "--cpu", "-q", "-i", str(_small_cube(tmp_path)),
         "--radius-of-gyration"],
        _env(tmp_path),
        timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "adius of gyration" in proc.stdout
    # print-and-exit: the recipe must NOT have run (initial cube area)
    assert "Total surface area: 6.0" in proc.stdout


def test_cli_repl_runs_commands_from_stdin(tmp_path):
    """Interactive REPL: commands piped on stdin execute, `q` exits cleanly,
    and the mesh saves on exit (reference main.py REPL loop)."""
    out = tmp_path / "repl_out.json"
    data = json.loads(CUBE.read_text())
    data.pop("instructions", None)
    mesh_path = tmp_path / "cube_noinstr.json"
    mesh_path.write_text(json.dumps(data))
    env = _env(tmp_path, MEMBRANE_HISTORY_FILE=str(tmp_path / "hist"))
    proc = subprocess.run(
        [sys.executable, "-m", "membrane_solver_tpu", "--cpu", "-q",
         "-i", str(mesh_path), "-o", str(out)],
        input="g2\nenergy\nq\n",
        capture_output=True,
        text=True,
        cwd=str(REPO),
        env=env,
        timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Interactive mode" in proc.stdout
    assert out.exists()
