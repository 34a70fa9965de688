#!/usr/bin/env python
"""Per-phase wall-clock breakdown of one L3 kozlov minimize step.

Each phase runs as the same standalone jitted program the minimize block
calls, timed with
block_until_ready (median of N calls after warmup).  The full step is the
bench.py L3 protocol (coupled 40-iteration inner tilt solve, fixed step
size).  Writes benchmarks/l3_step_breakdown.json.

    MEMBRANE_SOLVER_X64=0 python tools/profile_l3_step.py            # GPU f32
    python tools/profile_l3_step.py --platform cpu --steps 5         # debug
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _timed(fn, *args, warmup=3, reps=10):
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(statistics.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--refines", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20, help="full-step timing passes")
    ap.add_argument("--out", default=str(REPO / "benchmarks/l3_step_breakdown.json"))
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from membrane_solver_tpu import Minimizer, parse_geometry
    from membrane_solver_tpu.meshgen import build
    from membrane_solver_tpu.runtime import jit_core
    from membrane_solver_tpu.runtime import tilt_relax as _tr
    from membrane_solver_tpu.runtime.refinement import (
        refine_polygonal_facets,
        refine_triangle_mesh,
    )

    mesh = parse_geometry(build("kozlov_1disk"))
    mesh.global_parameters.update(
        {
            "tilt_solve_mode": "coupled",
            "tilt_step_size": 0.15,
            "tilt_inner_steps": 40,
            "tilt_tol": 1e-10,
            "step_size": 0.005,
            "step_size_mode": "fixed",
        }
    )
    mn = Minimizer(mesh, quiet=True)
    mn.step_size = 0.005
    for _ in range(args.refines):
        m = refine_polygonal_facets(mn.mesh)
        m = refine_triangle_mesh(m)
        mn.mesh = m
        mn.invalidate()
        mn.enforce_constraints_after_mesh_ops()

    p = mn.problem()
    dev = jax.devices()[0].platform
    dtype = str(p.state.positions.dtype)
    report = {
        "platform": dev,
        "device_kind": str(jax.devices()[0].device_kind),
        "dtype": dtype,
        "n_vertices": int(p.n_vertices),
        "n_tris": int(p.n_tris),
        "nv_cap": int(p.state.positions.shape[0]),
        "nf_cap": int(p.topo.tri_rows.shape[0]),
    }
    print(f"L3 problem: {report}")

    # warm the block + state (2 outer steps, like bench.py)
    mn.minimize(2)
    p = mn.problem()

    # --- full outer step (best-of-2: the first pass may trace the block) --
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        res = mn.minimize(args.steps)
        dt = time.perf_counter() - t0
        iters = max(int(res.get("iterations", args.steps)), 1)
        best = min(best, dt * 1e3 / iters)
        if res.get("terminated_early") or res.get("converged"):
            break
    report["full_step_ms"] = best
    p = mn.problem()

    params = p.params
    t_step = params.get("tilt_step_size", jnp.asarray(0.15))
    t_tol = params.get("tilt_tol", jnp.asarray(0.0))

    # --- inner tilt relax (the protocol's 40 coupled CG iterations) ------
    relax = _tr.make_relax_leaflet_tilts(p.spec)

    def run_relax(n):
        st, _stats = relax(
            p.state, p.topo, params, jnp.asarray(n, jnp.int32), t_step, t_tol
        )
        return st.tilts_in

    report["tilt_relax_40_ms"] = _timed(run_relax, 40)
    report["tilt_relax_0_ms"] = _timed(run_relax, 0)

    # --- shape energy + projected gradient (in-loop assembly) ------------
    eg = jit_core.make_energy_and_grad(p.spec)
    report["energy_projected_grad_ms"] = _timed(
        lambda: eg(p.state, p.topo, params)[1]
    )

    # --- raw value_and_grad and the KKT projector alone ------------------
    vg = jit_core.make_energy_vg(p.spec)
    report["energy_vg_ms"] = _timed(
        lambda: vg(p.state.positions, p.state, p.topo, params)[1]
    )
    projector = jit_core.make_gradient_projector(p.spec)
    if projector is not None:
        _, g = vg(p.state.positions, p.state, p.topo, params)
        g = jax.block_until_ready(g)
        proj_jit = jax.jit(projector)
        report["kkt_projector_ms"] = _timed(lambda: proj_jit(g, p.state, p.topo, params))

    # --- plain energy forward (one line-search trial evaluation) ---------
    efn = jit_core.make_energy_value(p.spec)
    report["energy_forward_ms"] = _timed(lambda: efn(p.state, p.topo, params))

    # --- per-trial geometric constraint enforcement -----------------------
    enforcer = jit_core.make_constraint_enforcer(p.spec)
    if enforcer is not None:
        report["constraint_enforce_ms"] = _timed(
            lambda: enforcer(p.state, p.topo, params, context="minimize").positions
        )

    # --- residual: line search + stepper + guards -------------------------
    known = report["tilt_relax_40_ms"] + report["energy_projected_grad_ms"]
    report["residual_ms"] = report["full_step_ms"] - known

    Path(args.out).write_text(json.dumps(report, indent=1) + "\n")
    for k, v in report.items():
        if isinstance(v, float):
            print(f"{k:28s} {v:10.3f}")
        else:
            print(f"{k:28s} {v}")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
