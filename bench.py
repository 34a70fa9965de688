#!/usr/bin/env python
"""Headline benchmark: per-minimization-step wall-clock on the kozlov
1-disk hard-rim coupled-tilt lane (BASELINE.json's headline config).

Prints ONE JSON line:
    {"metric": "...", "value": N, "unit": "...", "vs_baseline": N, ...}

Baseline: the NumPy reference (`AvishaiBarnoy/membrane_solver`) runs the
same lane (coupled tilt solve, 40 inner CG iterations, fixed 0.005 Armijo
steps) at 117.73 ms/step over 40 warm steps on a CPU host (measured
2026-08-16).  vs_baseline is the speedup factor (reference_time /
our_time).

One "step" = one full outer iteration: inner leaflet-tilt relaxation (up to
40 preconditioned CG iterations with KKT-projected gradients and per-step
rim re-enforcement), energy+gradient assembly, KKT shape projection, and a
10-trial Armijo line search with per-trial constraint enforcement — all as a
single jitted lax.while_loop program.

The headline lane is the L3 refinement (10,817 vertices) on the GPU in
float32; XLA:CPU float64 is measured alongside and labelled cpu_f64.  Each
lane runs in its own child process (clean backend + dtype), one at a time,
and the parent never initializes a GPU backend.  A run that finds no GPU
fails instead of reporting CPU numbers.  Set BENCH_LANE=cube770 for the
surface-tension lane, BENCH_PLATFORM=cpu/gpu to pin a backend, BENCH_STEPS
to change duration, BENCH_F64=1 to run the GPU in float64.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


LANES = {
    "kozlov": {
        # generated by meshgen in the child on every run
        "meshgen": "kozlov_1disk",
        "gp": {
            "tilt_solve_mode": "coupled",
            "tilt_step_size": 0.15,
            "tilt_inner_steps": 40,
            "tilt_tol": 1e-10,
            "step_size": 0.005,
            "step_size_mode": "fixed",
        },
        "step_size": 0.005,
        "metric": "kozlov_hard_rim_per_step_ms",
        "reference_ms": 117.73,
        "steps": 40,
        "warmup": 2,
    },
    "cube770": {
        "path": str(REPO / "benchmarks" / "inputs" / "cube_770.json"),
        "gp": {},
        "step_size": 0.028159473742371446,
        "metric": "cube770_gd_per_step_ms",
        "reference_ms": 17.527,
        "steps": 200,
        "warmup": 5,
    },
}

# the headline: the kozlov_1disk_3d lane refined to production scale
# (10,817 vertices after the lane's three refinement passes — verified
# identical vertex/facet counts on both solvers).  reference_ms is the
# NumPy reference re-measured on THIS mesh on a CPU host 2026-08-20
# (unloaded, 22.4-30.2 s/step across two clean processes; the minimum is
# used as the most conservative bar — benchmarks/ref_l3_remeasure.json).
# It supersedes the 16,260.5 recorded 2026-08-16, which was taken when
# the same lane produced a 6,577-vertex mesh (meshgen's kozlov_1disk
# initial mesh has since grown; the reference's dense KKT stack goes
# quadratic in mesh size).  Same protocol position, same coupled
# 40-iteration inner tilt solve.
LANES["kozlov_L3"] = {
    **LANES["kozlov"],
    "metric": "kozlov3d_L3_per_step_ms",
    "reference_ms": 22434.0,
    "refines": 3,
    "steps": 20,
    "warmup": 2,
    "timeout": 3000,
}

# L4 scaling lane (26,209 vertices): the reference NumPy stack measured
# 165 s/step on a CPU host (recorded round 1, "L4 scaling measurement"
# commit); opt-in via BENCH_LANE=kozlov_L4 — not part of the default
# headline run (compile + 10 steps keep it within the lane timeout).
LANES["kozlov_L4"] = {
    **LANES["kozlov"],
    "metric": "kozlov3d_L4_per_step_ms",
    "reference_ms": 165000.0,
    "refines": 4,
    "steps": 10,
    "warmup": 1,
    "timeout": 5400,
}


def measure(lane: dict, platform: str, x64: str) -> dict:
    """Run one lane in a child process; return its ms/step and device."""
    refines = int(lane.get("refines", 0))
    code = f"""
import json, time, sys
sys.path.insert(0, {str(REPO)!r})
import jax
jax.config.update("jax_platforms", {platform!r})
dev = jax.devices()[0]
if dev.platform != {platform!r}:
    sys.exit(f"bench: wanted {platform!r}, JAX found {{dev.platform}}")
from membrane_solver_tpu import Minimizer, load_data, parse_geometry
from membrane_solver_tpu.meshgen import build
lane = {json.dumps(lane)}
data = build(lane["meshgen"]) if "meshgen" in lane else load_data(lane["path"])
mesh = parse_geometry(data)
mesh.global_parameters.update(lane["gp"])
mn = Minimizer(mesh, quiet=True)
mn.step_size = lane["step_size"]
if {refines}:
    from membrane_solver_tpu.runtime.refinement import refine_polygonal_facets, refine_triangle_mesh
    for _ in range({refines}):
        m = refine_polygonal_facets(mn.mesh); m = refine_triangle_mesh(m)
        mn.mesh = m; mn.invalidate(); mn.enforce_constraints_after_mesh_ops()
steps = int({os.environ.get("BENCH_STEPS", 0)!r}) or lane["steps"]
mn.minimize(lane["warmup"])
# best-of-2 timed passes: robust to transient host load.  A pass that
# converges or zero-step-terminates early runs cheaper-than-full steps, so
# it only counts when no full pass completed (avoids biasing ms/step down).
best_full = float("inf")
best_any = float("inf")
for _ in range(2):
    t0 = time.perf_counter()
    res = mn.minimize(steps)
    dt = time.perf_counter() - t0
    iters = max(int(res.get("iterations", steps)), 1)
    per_step = dt / iters
    best_any = min(best_any, per_step)
    if res.get("terminated_early") or res.get("converged"):
        break  # the state is converged; a further pass measures nothing real
    best_full = min(best_full, per_step)
best = best_full if best_full < float("inf") else best_any
print("BENCH_RESULT " + json.dumps({{"ms": best * 1e3, "device_kind": dev.device_kind}}))
"""
    env = dict(os.environ, MEMBRANE_SOLVER_X64=x64)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=int(lane.get("timeout", 1800)),
    )
    for line in out.stdout.splitlines():
        if line.startswith("BENCH_RESULT "):
            return json.loads(line[len("BENCH_RESULT "):])
    raise RuntimeError(f"bench subprocess failed:\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")


def run_lane(lane: dict, configs) -> dict:
    """configs: iterable of (label, platform, x64); every config must run."""
    return {label: measure(lane, plat, x64) for label, plat, x64 in configs}


def _nvidia_smi() -> str | None:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() if out.returncode == 0 and out.stdout.strip() else None


def _configs(pin):
    gpu_x64 = "1" if os.environ.get("BENCH_F64") == "1" else "0"
    gpu = ("gpu_f64" if gpu_x64 == "1" else "gpu_f32", "gpu", gpu_x64)
    cpu = ("cpu_f64", "cpu", "1")
    if pin == "cpu":
        return [cpu]
    if pin == "gpu":
        return [gpu]
    return [gpu, cpu]


def _headline(results: dict) -> tuple[str, float]:
    """Headline = the GPU number when measured, never a silent min() across
    devices.  Every measured config is still reported side by side."""
    gpu = {k: v["ms"] for k, v in results.items() if k.startswith("gpu")}
    pool = gpu or {k: v["ms"] for k, v in results.items()}
    return min(pool.items(), key=lambda kv: kv[1])


def main() -> None:
    lane_name = os.environ.get("BENCH_LANE")
    pin = os.environ.get("BENCH_PLATFORM")
    if pin not in (None, "cpu", "gpu"):
        sys.exit(f"error: BENCH_PLATFORM must be cpu or gpu, not {pin!r}")
    configs = _configs(pin)
    card = _nvidia_smi()
    if any(plat == "gpu" for _, plat, _ in configs) and card is None:
        sys.exit("error: no NVIDIA GPU found (nvidia-smi); set BENCH_PLATFORM=cpu for host numbers")
    if lane_name and lane_name not in LANES:
        sys.exit(f"error: unknown BENCH_LANE {lane_name!r}; choose from {sorted(LANES)}")

    extras = {}
    if lane_name:
        lane = LANES[lane_name]
        results = run_lane(lane, configs)
    else:
        # default: headline = production-scale kozlov L3 lane; the small
        # hard-rim lane is measured on the same configs and reported alongside
        for label, res in run_lane(LANES["kozlov"], configs).items():
            extras[f"kozlov_small_{label}"] = round(res["ms"], 3)
        lane = LANES["kozlov_L3"]
        results = run_lane(lane, configs)
    platform, ms = _headline(results)
    out = {
        "metric": lane["metric"],
        "value": round(ms, 4),
        "unit": "ms/step",
        "vs_baseline": round(lane["reference_ms"] / ms, 2),
        "platform": platform,
        "device_kind": results[platform]["device_kind"],
        "card": card,
        "all": {**extras, **{k: round(v["ms"], 3) for k, v in results.items()}},
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
