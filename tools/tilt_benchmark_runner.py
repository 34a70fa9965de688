#!/usr/bin/env python
"""Evaluate tilt benchmark lanes and print energy/tilt/divergence summaries.

JAX analog of the reference's ``tools/tilt_benchmark_runner.py``
(248 LoC): for each tilt lane (generated by meshgen, or explicit mesh
paths), relax the tilt field, then report per-leaflet tilt magnitude
statistics, P1 divergence statistics, and the energy breakdown.

    python tools/tilt_benchmark_runner.py                 # built-in lanes
    python tools/tilt_benchmark_runner.py path/to/lane.yaml --json out.json
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

DEFAULT_LANES = ["gen:rect_tilt_source", "gen:kozlov_1disk"]


def summarize(minim) -> dict:
    import numpy as np

    from membrane_solver_tpu.device.tilt_ops import p1_triangle_divergence

    p = minim.problem()
    nv = p.n_vertices
    out: dict = {"energy": float(minim.compute_energy()),
                 "breakdown": {k: float(v) for k, v in minim.compute_energy_breakdown().items()}}
    for field in ("tilts", "tilts_in", "tilts_out"):
        t = np.asarray(getattr(p.state, field))[:nv]
        mag = np.linalg.norm(t, axis=1)
        if mag.max() <= 1e-300:
            continue
        div_tri, area, _ = p1_triangle_divergence(
            p.state.positions, getattr(p.state, field), p.topo.tri_rows, p.topo.tri_valid
        )
        div = np.asarray(div_tri)[np.asarray(p.topo.tri_valid)]
        out[field] = {
            "max": float(mag.max()),
            "mean": float(mag.mean()),
            "div_max": float(np.abs(div).max()) if div.size else 0.0,
            "div_mean": float(np.abs(div).mean()) if div.size else 0.0,
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("lanes", nargs="*", default=None,
                    help="mesh paths or gen:<builder> (default: built-in lanes)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--json", default=None, help="also write a JSON report")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from membrane_solver_tpu import load_data, parse_geometry
    from membrane_solver_tpu.meshgen import build
    from membrane_solver_tpu.runtime.minimizer import Minimizer

    report = {}
    for lane in args.lanes or DEFAULT_LANES:
        data = build(lane[4:]) if lane.startswith("gen:") else load_data(lane)
        mesh = parse_geometry(data)
        minim = Minimizer(mesh, quiet=True)
        minim.minimize(args.steps)
        summary = summarize(minim)
        report[lane] = summary
        print(f"== {lane}  E={summary['energy']:.10g}")
        for field in ("tilts", "tilts_in", "tilts_out"):
            if field in summary:
                s = summary[field]
                print(f"   {field:9s} |t| max={s['max']:.6g} mean={s['mean']:.6g}  "
                      f"|div| max={s['div_max']:.6g} mean={s['div_mean']:.6g}")

    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=1) + "\n")
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
