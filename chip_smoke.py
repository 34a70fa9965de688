#!/usr/bin/env python
"""Smoke test of the minimizer on one NVIDIA GPU, through its user entry points.

    python chip_smoke.py            # one GPU: CLI, kozlov lanes f64 and f32
    python chip_smoke.py --multi    # four GPUs: sharded sweep + tensor-parallel block

The parent process never initializes a GPU backend: every phase runs in a
child process, one child at a time, so only one process holds the card.
Each child prints its own report and ends with one ``CHILD_RESULT {json}``
line; the parent checks the results, prints the card's name and power
limit, and prints as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

A missing GPU, a missing package, a failed phase or a result outside its
tolerance ends the run with a non-zero exit code and no such line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

CUBE_ENERGY = 4.8352050657426  # meshes/cube.json recipe, f64 reference value
CUBE_RTOL = 1e-8
# GPU and CPU sum in different orders (atomic scatter-adds, tree reductions),
# so f64 trajectories agree to roundoff amplified by the 40-iteration inner
# tilt CG and the line search — not bit for bit.
DEVICE_RTOL = 1e-9
# f32 vs f64 trajectory bound per lane.  L3 starts 6.5e-4 apart before its
# first step and sits at 1.04e-3 after it.  The whole offset is the
# tilt_thetaB_contact_in bookkeeping term (-2 pi R_eff gamma theta_B, no
# gradient): refinement grows its theta_B group from a 16-vertex ring into
# 1,584 vertices on shared azimuths, and the arc-length weights of R_eff
# follow an angular sort whose ties roundoff breaks differently in f32.
# Every other term agrees to ~1e-7.
F32_RTOL = {"small": 1e-3, "L3": 1.1e-3}
KOZLOV_GP = {
    "tilt_solve_mode": "coupled",
    "tilt_step_size": 0.15,
    "tilt_inner_steps": 40,
    "tilt_tol": 1e-10,
    "step_size": 0.005,
    "step_size_mode": "fixed",
}
L3_SIZE = (10_817, 21_504)  # vertices, triangles after three refines
# (name, refines, steps, compiling steps left out of the median)
LANES = (("small", 0, 10, 1), ("L3", 3, 7, 2))


class PhaseError(RuntimeError):
    """A phase failed or missed its tolerance."""


# ----------------------------------------------------------------------
# phases (import the package lazily: the parent must stay off JAX)
# ----------------------------------------------------------------------
def phase_device(expect_count: int | None = None) -> dict:
    """Phase 0: the default JAX device must be a GPU."""
    import jax
    import jaxlib

    from membrane_solver_tpu import compile_cache_dir

    devices = jax.devices()
    info = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }
    print(f"jax {jax.__version__} jaxlib {jaxlib.__version__}; devices {info}")
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache {compile_cache_dir()}")
    if info["platform"] != "gpu":
        raise PhaseError(f"no GPU: JAX's default device is {info['platform']}")
    if expect_count is not None and info["count"] < expect_count:
        raise PhaseError(f"need {expect_count} GPUs, JAX sees {info['count']}")
    return info


def phase_cli(out_dir: Path) -> float:
    """Phase 1: the cube recipe through ``cli.main``; returns its final energy."""
    import logging

    from membrane_solver_tpu import cli

    energies: list[float] = []

    class _Capture(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith("Minimization complete. Final energy:"):
                energies.append(float(msg.rsplit(":", 1)[1]))

    out_dir.mkdir(parents=True, exist_ok=True)
    out_mesh = out_dir / "cube_out.json"
    handler = _Capture()
    logger = logging.getLogger("membrane_solver_tpu")
    logger.addHandler(handler)
    try:
        t0 = time.perf_counter()
        rc = cli.main(
            ["--non-interactive", "-q", "-i", str(REPO / "meshes" / "cube.json"),
             "-o", str(out_mesh)]
        )
        wall = time.perf_counter() - t0
    finally:
        logger.removeHandler(handler)
    if rc != 0 or not energies or not out_mesh.is_file():
        raise PhaseError(f"CLI cube recipe failed (rc={rc}, energies={energies})")
    energy = energies[-1]
    rel = abs(energy - CUBE_ENERGY) / CUBE_ENERGY
    print(f"cli cube: final energy {energy!r} (rel dev {rel:.3e} vs {CUBE_ENERGY}), "
          f"{wall:.2f} s wall incl. compile")
    if rel > CUBE_RTOL:
        raise PhaseError(f"cube energy {energy!r} off by {rel:.3e} > {CUBE_RTOL}")
    return energy


def kozlov_minimizer(refines: int):
    """The bench.py kozlov 1-disk hard-rim lane, refined ``refines`` times."""
    from membrane_solver_tpu import Minimizer, parse_geometry
    from membrane_solver_tpu.meshgen import build
    from membrane_solver_tpu.runtime.refinement import (
        refine_polygonal_facets,
        refine_triangle_mesh,
    )

    mesh = parse_geometry(build("kozlov_1disk"))
    mesh.global_parameters.update(KOZLOV_GP)
    mn = Minimizer(mesh, quiet=True)
    mn.step_size = KOZLOV_GP["step_size"]
    for _ in range(refines):
        mn.mesh = refine_triangle_mesh(refine_polygonal_facets(mn.mesh))
        mn.invalidate()
        mn.enforce_constraints_after_mesh_ops()
    return mn


def run_lane(refines: int, n_steps: int, device) -> dict:
    """Run ``n_steps`` single outer steps on ``device``; per-step energy and time."""
    import jax

    with jax.default_device(device):
        t0 = time.perf_counter()
        mn = kozlov_minimizer(refines)
        setup_s = time.perf_counter() - t0
        energies, step_s = [], []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            res = mn.minimize(1)  # returns the energy as a host float: synced
            step_s.append(time.perf_counter() - t0)
            energies.append(float(res["energy"]))
        spec = mn.problem().spec
    return {
        "nv": len(mn.mesh.vertices),
        "nf": len(mn.mesh.facets),
        "nv_cap": spec.nv_cap,
        "nf_cap": spec.nf_cap,
        "setup_s": setup_s,
        "energies": energies,
        "step_s": step_s,
    }


def max_rel_dev(a, b) -> float:
    return max(abs(x - y) / max(abs(y), 1e-300) for x, y in zip(a, b, strict=True))


def compare_trajectories(label: str, got, ref, rtol: float) -> float:
    dev = max_rel_dev(got, ref)
    print(f"{label}: max rel energy deviation {dev:.3e} (tolerance {rtol:.1e})")
    if not dev <= rtol:
        raise PhaseError(f"{label}: deviation {dev:.3e} > {rtol:.1e}")
    return dev


def steady_ms(step_s, skip: int) -> float:
    """Median step time in ms after the first ``skip`` (compiling) steps."""
    return 1e3 * statistics.median(step_s[skip:])


def report_lane(label: str, run: dict, skip: int) -> None:
    print(
        f"{label}: {run['nv']} vertices / {run['nf']} triangles "
        f"(padded {run['nv_cap']} / {run['nf_cap']}); "
        f"{steady_ms(run['step_s'], skip):.3f} ms/step median of steps {skip + 1}..{len(run['step_s'])}; "
        f"first step {run['step_s'][0]:.2f} s (compile); setup {run['setup_s']:.2f} s"
    )


def phase_lanes(gpu, cpu, lanes=LANES) -> dict:
    """Phases 2-3 (f64): the small lane (10 steps) and L3 (2 warm-up + 5) on
    the GPU, each against the same steps on the host CPU."""
    out = {}
    for name, refines, n_steps, skip in lanes:
        g = run_lane(refines, n_steps, gpu)
        peak = (gpu.memory_stats() or {}).get("peak_bytes_in_use")
        c = run_lane(refines, n_steps, cpu)
        report_lane(f"{name} f64 gpu", g, skip)
        report_lane(f"{name} f64 cpu", c, skip)
        print(f"{name} f64 gpu: process peak device memory so far {peak} bytes")
        dev = compare_trajectories(f"{name} f64 gpu vs cpu", g["energies"], c["energies"], DEVICE_RTOL)
        out[name] = {
            "nv": g["nv"], "nf": g["nf"], "energies": g["energies"],
            "gpu_ms": steady_ms(g["step_s"], skip), "cpu_ms": steady_ms(c["step_s"], skip),
            "gpu_first_step_s": g["step_s"][0], "peak_bytes": peak, "gpu_vs_cpu": dev,
        }
    if "L3" in out and (out["L3"]["nv"], out["L3"]["nf"]) != L3_SIZE:
        raise PhaseError(f"L3 lane has {out['L3']['nv']} / {out['L3']['nf']}, want {L3_SIZE}")
    return out


def phase_f32(lanes=LANES) -> dict:
    """Phase 4 (fresh process, x64 off): the same lanes in float32 on the GPU.

    There is no phase 5: the device path has no hand-written kernel, so
    every device op is XLA's own and phases 1-4 check them end to end."""
    import jax

    if jax.config.jax_enable_x64:
        raise PhaseError("the f32 phase needs MEMBRANE_SOLVER_X64=0 at import")
    gpu = jax.devices()[0]
    out = {}
    for name, refines, n_steps, skip in lanes:
        g = run_lane(refines, n_steps, gpu)
        report_lane(f"{name} f32 gpu", g, skip)
        out[name] = {"energies": g["energies"], "gpu_ms": steady_ms(g["step_s"], skip)}
    return out


def phase_multi(n: int = 4) -> dict:
    """--multi: the sharded sweep and the tensor-parallel minimize block over
    ``n`` devices, each against its single-device run (1e-9)."""
    sys.path.insert(0, str(REPO))
    import __graft_entry__

    return __graft_entry__.dryrun_multichip(n)


# ----------------------------------------------------------------------
# child and parent
# ----------------------------------------------------------------------
def _child(role: str, out_dir: Path) -> dict:
    import jax

    if role == "f64":
        info = phase_device()
        cli_e = phase_cli(out_dir)
        lanes = phase_lanes(jax.devices()[0], jax.devices("cpu")[0])
        return {"device": info, "cli_energy": cli_e, "lanes": lanes}
    if role == "f32":
        info = phase_device()
        return {"device": info, "lanes": phase_f32()}
    if role == "multi":
        info = phase_device(expect_count=4)
        return {"device": info, "multi": phase_multi(4)}
    raise PhaseError(f"unknown child role {role!r}")


def _run_child(role: str, out_dir: Path, env_extra: dict | None = None) -> dict | None:
    env = dict(os.environ, **(env_extra or {}))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child", role, "--out", str(out_dir)]
    print(f"== {role}", flush=True)
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, text=True)
    result = None
    try:
        for line in proc.stdout:
            if line.startswith("CHILD_RESULT "):
                result = json.loads(line[len("CHILD_RESULT "):])
            else:
                print(line, end="", flush=True)
        rc = proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0 or result is None:
        print(f"chip_smoke: child {role!r} failed (exit {rc})", file=sys.stderr)
        return None
    return result


def _nvidia_smi() -> str | None:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    text = out.stdout.strip()
    return text if out.returncode == 0 and text else None


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--multi", action="store_true", help="four-GPU sweep and tensor-parallel path only")
    p.add_argument("--out", type=Path, default=REPO / "smoke_out",
                   help="directory for the cube output mesh and the JSON record")
    p.add_argument("--child", help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.child:
        try:
            result = _child(args.child, args.out)
        except PhaseError as exc:
            print(f"chip_smoke: {exc}", file=sys.stderr)
            return 1
        print("CHILD_RESULT " + json.dumps(result), flush=True)
        return 0

    if not (REPO / "membrane_solver_tpu" / "__init__.py").is_file():
        print("chip_smoke: the membrane_solver_tpu package is not next to this script",
              file=sys.stderr)
        return 2
    card = _nvidia_smi()
    if card is None:
        print("chip_smoke: no NVIDIA GPU found (nvidia-smi)", file=sys.stderr)
        return 1
    print(f"card: {card}", flush=True)  # first, so that a failed run records it too

    if args.multi:
        res = _run_child("multi", args.out)
        if res is None:
            return 1
        device = res["device"]
    else:
        f64 = _run_child("f64", args.out)
        if f64 is None:
            return 1
        f32 = _run_child("f32", args.out, {"MEMBRANE_SOLVER_X64": "0"})
        if f32 is None:
            return 1
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "smoke.json").write_text(
            json.dumps({"card": card, "f64": f64, "f32": f32}, indent=1)
        )
        try:
            for lane in ("small", "L3"):
                compare_trajectories(
                    f"{lane} f32 vs f64 (gpu)",
                    f32["lanes"][lane]["energies"], f64["lanes"][lane]["energies"],
                    F32_RTOL[lane],
                )
        except PhaseError as exc:
            print(f"chip_smoke: {exc}", file=sys.stderr)
            return 1
        device = f64["device"]

    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
