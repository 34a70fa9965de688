"""AOT export-cache parity: the replayed StableHLO must produce the same
minimization results as the live-traced path (utils/aot_cache.py)."""

from __future__ import annotations

import importlib

import numpy as np
import pytest


@pytest.fixture()
def aot_env(tmp_path, monkeypatch):
    monkeypatch.setenv("MEMBRANE_SOLVER_AOT_CACHE", "1")
    monkeypatch.delenv("MEMBRANE_SOLVER_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    import membrane_solver_tpu.utils.aot_cache as ac

    importlib.reload(ac)
    yield ac, tmp_path / "aot"
    monkeypatch.setenv("MEMBRANE_SOLVER_AOT_CACHE", "0")
    importlib.reload(ac)


def _run_cube_steps():
    from membrane_solver_tpu import Minimizer, load_data, parse_geometry
    from membrane_solver_tpu.runtime import jit_core

    jit_core._BLOCK_CACHE.clear()
    mesh = parse_geometry(load_data("meshes/cube.json"))
    mn = Minimizer(mesh, quiet=True)
    mn.step_size = 0.01
    mn.minimize(5)
    return float(mn.compute_energy())


def test_aot_replay_matches_live_trace(aot_env):
    ac, cache_dir = aot_env
    e_live = None
    import os

    os.environ["MEMBRANE_SOLVER_AOT_CACHE"] = "0"
    e_live = _run_cube_steps()
    os.environ["MEMBRANE_SOLVER_AOT_CACHE"] = "1"
    e_export = _run_cube_steps()  # populates the cache via export
    files = list(cache_dir.glob("*.stablehlo"))
    assert files, "export cache produced no artifacts"
    e_replay = _run_cube_steps()  # replays the deserialized modules
    assert np.isfinite(e_live)
    assert e_export == pytest.approx(e_live, rel=0, abs=0)
    assert e_replay == pytest.approx(e_live, rel=0, abs=0)
