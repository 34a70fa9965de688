"""Where the persistent compile caches live (membrane_solver_tpu.__init__,
utils/aot_cache.py): JAX_COMPILATION_CACHE_DIR when set, otherwise one fixed
directory in the checkout; the AOT export cache sits under it."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import membrane_solver_tpu
from membrane_solver_tpu.utils import aot_cache

REPO = Path(__file__).resolve().parent.parent


def test_env_var_sets_both_caches(monkeypatch, tmp_path):
    monkeypatch.delenv("MEMBRANE_SOLVER_COMPILE_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert membrane_solver_tpu.compile_cache_dir() == tmp_path
    assert aot_cache._cache_dir() == tmp_path / "aot"


def test_unset_env_var_uses_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("MEMBRANE_SOLVER_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert membrane_solver_tpu.compile_cache_dir() == REPO / ".jax_cache"
    assert aot_cache._cache_dir() == REPO / ".jax_cache" / "aot"


def test_zero_disables_both_caches(monkeypatch, tmp_path):
    monkeypatch.setenv("MEMBRANE_SOLVER_COMPILE_CACHE", "0")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("MEMBRANE_SOLVER_AOT_CACHE", "1")
    assert membrane_solver_tpu.compile_cache_dir() is None
    assert aot_cache._cache_dir() is None
    assert not aot_cache.enabled()


def _configured_dir(env_dir: str | None) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in {"MEMBRANE_SOLVER_COMPILE_CACHE", "JAX_COMPILATION_CACHE_DIR"}}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = (
        "import json, jax, membrane_solver_tpu as m; "
        "print(json.dumps([str(m.compile_cache_dir()), jax.config.jax_compilation_cache_dir]))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_import_configures_jax_with_a_stable_path(tmp_path, env_dir):
    """Two fresh processes agree on the directory: nothing in it comes from
    a temporary name, the process id or the clock."""
    want = str(REPO / ".jax_cache") if env_dir is None else str(tmp_path / env_dir)
    arg = None if env_dir is None else want
    first, second = _configured_dir(arg), _configured_dir(arg)
    assert first == second == [want, want]
