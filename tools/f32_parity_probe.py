#!/usr/bin/env python
"""f32-tracks-f64 trajectory probe across benchmark lanes.

The bench headline runs float32 on the GPU.  That leans on a recorded
bound: the f32 trajectory must track the f64 trajectory within a small
relative energy deviation over the measured window.

Per lane: run the same minimization protocol twice in fresh subprocesses
(clean global dtype), one at a time, once f64 on the CPU and once f32,
recording the energy after every outer step; report max/final relative
deviation.  Defaults to CPU for both (dtype is the dominant difference).

    python tools/f32_parity_probe.py                 # all lanes, CPU
    python tools/f32_parity_probe.py kozlov_L3       # one lane
    python tools/f32_parity_probe.py --platform gpu  # f32 leg on the GPU

Writes benchmarks/f32_parity.json (merging per-lane entries).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402  (lane registry: inputs/gp/step sizes)

OUT = REPO / "benchmarks" / "f32_parity.json"

# lane -> (bench.LANES key, probe steps).  kozlov covers the coupled-tilt
# hard-rim physics, L3 the production scale, cube770 the surface-tension
# lane; tensionless (suite runner gp) is the tilt-source-heavy lane.
PROBE_LANES = {
    "kozlov": ("kozlov", 40),
    "kozlov_L3": ("kozlov_L3", 20),
    "kozlov_L4": ("kozlov_L4", 10),
    "cube770": ("cube770", 120),
}


def _trace(lane: dict, steps: int, platform: str, x64: bool) -> list[float]:
    """Energy after each outer minimize step, in a fresh subprocess."""
    refines = int(lane.get("refines", 0))
    code = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
import jax
jax.config.update("jax_platforms", {platform!r})
from membrane_solver_tpu import Minimizer, load_data, parse_geometry
from membrane_solver_tpu.meshgen import build
lane = {json.dumps(lane)}
mesh = parse_geometry(build(lane["meshgen"]) if "meshgen" in lane else load_data(lane["path"]))
mesh.global_parameters.update(lane["gp"])
mn = Minimizer(mesh, quiet=True)
mn.step_size = lane["step_size"]
for _ in range({refines}):
    from membrane_solver_tpu.runtime.refinement import refine_polygonal_facets, refine_triangle_mesh
    m = refine_polygonal_facets(mn.mesh); m = refine_triangle_mesh(m)
    mn.mesh = m; mn.invalidate(); mn.enforce_constraints_after_mesh_ops()
trace = []
for _ in range({steps}):
    mn.minimize(1)
    trace.append(float(mn.compute_energy()))
print("TRACE", json.dumps(trace))
"""
    env = dict(os.environ, MEMBRANE_SOLVER_X64="1" if x64 else "0")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=int(lane.get("timeout", 3600)),
    )
    for line in out.stdout.splitlines():
        if line.startswith("TRACE"):
            return json.loads(line.split(" ", 1)[1])
    raise RuntimeError(f"probe subprocess failed:\n{out.stdout[-1500:]}\n{out.stderr[-1500:]}")


def probe_lane(name: str, platform_f32: str) -> dict:
    lane_key, steps = PROBE_LANES[name]
    lane = bench.LANES[lane_key]
    t0 = time.time()
    e64 = _trace(lane, steps, "cpu", x64=True)
    e32 = _trace(lane, steps, platform_f32, x64=False)
    rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(e32, e64)]
    entry = {
        "steps": steps,
        "platform_f32": platform_f32,
        "max_rel_energy_dev": max(rel),
        "final_rel_energy_dev": rel[-1],
        "final_E_f64": e64[-1],
        "final_E_f32": e32[-1],
        "recorded": time.strftime("%Y-%m-%d"),
        "wall_s": round(time.time() - t0, 1),
    }
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", default=None)
    ap.add_argument("--platform", default="cpu", choices=["cpu", "gpu"],
                    help="platform for the f32 leg")
    args = ap.parse_args(argv)
    names = args.names or [n for n in PROBE_LANES if n != "kozlov_L4"]

    results = json.loads(OUT.read_text()) if OUT.exists() else {}
    for name in names:
        if name not in PROBE_LANES:
            print(f"unknown lane {name}; known: {sorted(PROBE_LANES)}")
            return 2
        entry = probe_lane(name, args.platform)
        key = name if args.platform == "cpu" else f"{name}@{args.platform}"
        results[key] = entry
        print(f"{key:20s} max_rel={entry['max_rel_energy_dev']:.3e} "
              f"final_rel={entry['final_rel_energy_dev']:.3e} "
              f"E64={entry['final_E_f64']:.8g} ({entry['wall_s']}s)")
    OUT.write_text(json.dumps(results, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
