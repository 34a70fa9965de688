"""On-GPU smoke tier (``pytest -m gpu``): runs chip_smoke.py on the card.

Deselected by default (pytest.ini).  The test process itself stays on the
host CPU (conftest); chip_smoke.py runs in a child process that owns the
card, one process at a time.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def gpu_card() -> str:
    sys.path.insert(0, str(REPO))
    import chip_smoke

    card = chip_smoke._nvidia_smi()
    if card is None:
        pytest.skip("no NVIDIA GPU on this machine")
    return card


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_card):
    env = {
        k: v for k, v in os.environ.items()
        if k not in {"JAX_PLATFORMS", "XLA_FLAGS", "MEMBRANE_SOLVER_COMPILE_CACHE"}
    }
    res = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=1200,
    )
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] is True
    assert last["device"]["platform"] == "gpu"
