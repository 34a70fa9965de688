#!/usr/bin/env python3
"""Reproduce the flat one-leaflet disk benchmark (docs/tex/1_disk_flat.tex).

JAX port of the reference's scientific acceptance protocol
(reference tools/reproduce_flat_disk_one_leaflet.py, default scan lanes):

1. load the kozlov free-disk fixture, refine ``refine_level`` times;
2. configure the one-leaflet benchmark (outer leaflet ``disabled`` — tilts
   zeroed + fixed — or ``free``), solver mapping ``legacy``:
   bending_modulus_in = kappa_t, tilt_modulus_in = kappa_t^2 / kappa
   (flat_disk_one_leaflet_theory.solver_mapping_from_theory);
3. theta scan: for each theta_B in linspace(theta_min, theta_max, count),
   zero the tilts, relax leaflet tilts at frozen positions (gd, 250 inner
   steps, step 0.08, tol 1e-12), record the relaxed energy; quadratic fit
   of the 3-point bracket around the grid minimum -> theta*;
4. re-relax at theta*, compute profile/planarity/outer metrics and — for
   the free mode — the outer decay probe (perturb outer tilts by seeded
   noise, conservative re-relax, measure the residual);
5. compare against closed-form TeX theory (Bessel I1/K1 quadratic
   coefficients) and, with ``--baseline``, field-by-field against the
   reference's recorded fixture
   (reference tests/fixtures/flat_disk_one_leaflet_{free,disabled}_baseline.yaml).

Usage:
    python tools/reproduce_flat_disk_one_leaflet.py --outer-mode free
    python tools/reproduce_flat_disk_one_leaflet.py --outer-mode disabled \
        --baseline /root/reference/tests/fixtures/flat_disk_one_leaflet_disabled_baseline.yaml
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

DEFAULT_FIXTURE = "/root/reference/tests/fixtures/kozlov_1disk_3d_free_disk_theory_parity.yaml"


# ----------------------------------------------------------------------
# closed-form theory (reference tools/diagnostics/flat_disk_one_leaflet_theory.py)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class FlatDiskTheoryParams:
    kappa: float
    kappa_t: float
    radius: float
    drive: float


def tex_reference_params() -> FlatDiskTheoryParams:
    """Parameter set stated in docs/tex/1_disk_flat.tex."""
    return FlatDiskTheoryParams(
        kappa=1.0, kappa_t=225.0, radius=0.4666666667, drive=4.285714286
    )


def solver_mapping_from_theory(params: FlatDiskTheoryParams, parameterization="legacy"):
    if parameterization == "legacy":
        return {
            "bending_modulus_in": float(params.kappa_t),
            "tilt_modulus_in": float(params.kappa_t**2 / params.kappa),
        }
    if parameterization == "kh_physical":
        return {
            "bending_modulus_in": float(params.kappa),
            "tilt_modulus_in": float(params.kappa_t),
        }
    raise ValueError("parameterization must be 'legacy' or 'kh_physical'")


def compute_flat_disk_theory(params: FlatDiskTheoryParams) -> dict:
    """Quadratic reduced-energy theory E(theta) = A theta^2 - B theta."""
    from scipy import special

    lam = math.sqrt(params.kappa / params.kappa_t)
    x = params.radius / lam
    i0, i1 = float(special.iv(0, x)), float(special.iv(1, x))
    k0, k1 = float(special.kv(0, x)), float(special.kv(1, x))
    ratio_i1_i0 = i1 / i0
    ratio_k1_k0 = k1 / k0
    coeff_A = math.pi * params.kappa_t * params.radius / lam * (ratio_i1_i0 + ratio_k1_k0)
    coeff_B = 2.0 * math.pi * params.radius * params.drive
    theta_star = coeff_B / (2.0 * coeff_A)
    elastic_inner = math.pi * params.kappa_t * params.radius / lam * theta_star**2 * ratio_i1_i0
    elastic_outer = math.pi * params.kappa_t * params.radius / lam * theta_star**2 * ratio_k1_k0
    contact = -coeff_B * theta_star
    return {
        **asdict(params),
        "lambda_value": lam,
        "lambda_inverse": 1.0 / lam,
        "lambda_radius": x,
        "ratio_i1_i0": ratio_i1_i0,
        "ratio_k1_k0": ratio_k1_k0,
        "coeff_A": coeff_A,
        "coeff_B": coeff_B,
        "theta_star": theta_star,
        "elastic_inner": elastic_inner,
        "elastic_outer": elastic_outer,
        "contact": contact,
        "total": elastic_inner + elastic_outer + contact,
    }


def compute_flat_disk_kh_physical_theory(params: FlatDiskTheoryParams) -> dict:
    """Strict KH flat-disk closed form (reference tools/diagnostics/
    flat_disk_one_leaflet_theory.py:307-418).

    f = 0.5*kappa*(div t)^2 + 0.5*kappa_t*|t|^2; the internal quadratic
    coefficient A comes from radial integration of the Bessel profile at
    theta_B = 1 (not the reduced-form approximation), B = 2*pi*R*drive.
    """
    import math

    from scipy import integrate, special

    kappa, kappa_t = float(params.kappa), float(params.kappa_t)
    radius, drive = float(params.radius), float(params.drive)
    lam = math.sqrt(kappa / kappa_t)
    x = radius / lam
    i0, i1 = float(special.iv(0, x)), float(special.iv(1, x))
    k0, k1 = float(special.kv(0, x)), float(special.kv(1, x))
    amp_in, amp_out = 1.0 / i1, 1.0 / k1

    def inner(rr):
        t = amp_in * special.iv(1, rr / lam)
        d = (amp_in / lam) * special.iv(0, rr / lam)
        return math.pi * rr * (kappa_t * t * t + kappa * d * d)

    def outer(rr):
        t = amp_out * special.kv(1, rr / lam)
        d = -(amp_out / lam) * special.kv(0, rr / lam)
        return math.pi * rr * (kappa_t * t * t + kappa * d * d)

    e_in_unit, _ = integrate.quad(inner, 0.0, radius, epsabs=1e-12, epsrel=1e-12, limit=500)
    e_out_unit, _ = integrate.quad(outer, radius, np.inf, epsabs=1e-12, epsrel=1e-12, limit=500)
    coeff_A = float(e_in_unit + e_out_unit)
    coeff_B = 2.0 * math.pi * radius * drive
    theta_star = coeff_B / (2.0 * coeff_A)
    elastic_inner = e_in_unit * theta_star**2
    elastic_outer = e_out_unit * theta_star**2
    contact = -coeff_B * theta_star
    return {
        **asdict(params),
        "lambda_value": lam,
        "lambda_inverse": 1.0 / lam,
        "lambda_radius": x,
        "ratio_i1_i0": i1 / i0,
        "ratio_k1_k0": k1 / k0,
        "coeff_A": coeff_A,
        "coeff_B": coeff_B,
        "theta_star": theta_star,
        "elastic_inner": elastic_inner,
        "elastic_outer": elastic_outer,
        "contact": contact,
        "total": elastic_inner + elastic_outer + contact,
    }


def _factor_difference(measured: float, target: float) -> float:
    t, m = abs(float(target)), abs(float(measured))
    if t < 1e-18:
        return 1.0 if m < 1e-18 else float("inf")
    ratio = m / t
    return float(max(ratio, 1.0 / ratio)) if ratio > 0 else float("inf")


def quadratic_min_from_scan(theta_values, energy_values) -> dict:
    """Convex quadratic fit through the 3-point bracket (theory module)."""
    t = np.asarray(theta_values, dtype=float)
    e = np.asarray(energy_values, dtype=float)
    a, b, c = np.polyfit(t, e, 2)
    if a <= 0:
        raise ValueError("scan bracket is not convex")
    theta_star = float(-b / (2.0 * a))
    return {
        "coeff_a": float(a),
        "coeff_b": float(b),
        "coeff_c": float(c),
        "theta_star": theta_star,
        "energy_star": float(np.polyval([a, b, c], theta_star)),
    }


# ----------------------------------------------------------------------
# benchmark protocol
# ----------------------------------------------------------------------
def configure_benchmark_mesh(
    mesh,
    *,
    theory: FlatDiskTheoryParams,
    outer_mode: str,
    parameterization: str = "legacy",
    smoothness_model: str = "dirichlet",
):
    """Reference _configure_benchmark_mesh (reproduce_flat_disk_one_leaflet.py
    :858-1060): legacy/dirichlet defaults plus the kh_physical/splay_twist
    branch used by benchmark_flat_disk_tilt_mass_mode.py."""
    gp = mesh.global_parameters
    mapping = solver_mapping_from_theory(theory, parameterization)
    gp.update(
        {
            "tilt_solver": "gd",
            "mesh_quality_auto_repair_enabled": False,
            "surface_tension": 0.0,
            "step_size_mode": "fixed",
            "step_size": 0.0,
            "tilt_solve_mode": "coupled",
            "tilt_step_size": 0.08,
            "tilt_inner_steps": 250,
            "tilt_tol": 1e-12,
            "tilt_kkt_projection_during_relaxation": False,
            "tilt_thetaB_optimize": False,
            "tilt_thetaB_group_in": "disk",
            "rim_slope_match_disk_group": "disk",
            "tilt_thetaB_contact_penalty_mode": "off",
            "tilt_thetaB_contact_strength_in": float(theory.drive),
            "tilt_thetaB_value": 0.0,
            "tilt_thetaB_center": [0.0, 0.0, 0.0],
            "tilt_thetaB_normal": [0.0, 0.0, 1.0],
            "pin_to_plane_normal": [0.0, 0.0, 1.0],
            "pin_to_plane_point": [0.0, 0.0, 0.0],
            # the fixture ships leaflet-absence presets; the benchmark runs
            # with the full out leaflet (reference configure clears it)
            "leaflet_out_absent_presets": [],
            "bending_modulus_in": float(mapping["bending_modulus_in"]),
            "tilt_modulus_in": float(mapping["tilt_modulus_in"]),
            "tilt_mass_mode_in": "lumped",
            "tilt_mass_mode_out": "lumped",
            "tilt_transport_model": "ambient_v1",
            "tilt_twist_modulus_in": 0.0,
        }
    )
    if smoothness_model == "dirichlet":
        smoothness_in_module = "tilt_smoothness_in"
    elif smoothness_model == "splay_twist":
        # Kozlov-Hamm split smoothness (reference :1017-1023): splay modulus
        # follows the leaflet bending modulus, twist stays 0
        smoothness_in_module = "tilt_splay_twist_in"
        gp.set("tilt_splay_modulus_in", float(mapping["bending_modulus_in"]))
    else:
        raise ValueError("smoothness_model must be 'dirichlet' or 'splay_twist'")
    if outer_mode == "disabled":
        mesh.energy_modules[:] = ["tilt_in", smoothness_in_module, "tilt_thetaB_contact_in"]
        for v in mesh.vertices.values():
            v.tilt_out = np.zeros(3)
            v.tilt_fixed_out = True
    elif outer_mode == "free":
        mesh.energy_modules[:] = [
            "tilt_in",
            smoothness_in_module,
            "tilt_out",
            "tilt_smoothness_out",
            "tilt_thetaB_contact_in",
        ]
        gp.update(
            {
                "bending_modulus_out": float(mapping["bending_modulus_in"]),
                "tilt_modulus_out": float(mapping["tilt_modulus_in"]),
                "tilt_twist_modulus_out": 0.0,
            }
        )
        for v in mesh.vertices.values():
            v.tilt_out = np.zeros(3)
    else:
        raise ValueError("outer_mode must be 'disabled' or 'free'")
    # the dirichlet smoothness modulus follows the leaflet bending modulus
    gp.update(
        {
            "tilt_smoothness_modulus_in": float(mapping["bending_modulus_in"]),
            "tilt_smoothness_modulus_out": float(mapping["bending_modulus_in"]),
        }
    )
    mesh.constraint_modules[:] = ["pin_to_plane", "pin_to_circle", "tilt_thetaB_boundary_in"]


def run_theta_relaxation(minim, *, theta_value: float, reset_outer: bool) -> float:
    mesh = minim.mesh
    mesh.global_parameters.set("tilt_thetaB_value", float(theta_value))
    p = minim.problem()
    import dataclasses as _dc

    import jax.numpy as jnp

    zeros = jnp.zeros_like(p.state.tilts_in)
    p.state = _dc.replace(
        p.state,
        tilts_in=zeros,
        tilts_out=zeros if reset_outer else p.state.tilts_out,
    )
    minim.relax_leaflet_tilts()
    return float(minim.compute_energy())


def radial_profile_metrics(minim, radius: float) -> dict:
    p = minim.problem()
    nv = p.n_vertices
    pos = np.asarray(p.state.positions[:nv])
    tin = np.asarray(p.state.tilts_in[:nv])
    r = np.linalg.norm(pos[:, :2], axis=1)
    r_hat = np.zeros_like(pos)
    good = r > 1e-12
    r_hat[good, 0] = pos[good, 0] / r[good]
    r_hat[good, 1] = pos[good, 1] / r[good]
    t_rad = np.einsum("ij,ij->i", tin, r_hat)
    rim = (r >= 0.90 * radius) & (r <= 1.10 * radius)
    outer = (r >= 2.0 * radius) & (r <= 4.0 * radius)
    inner = r < 0.60 * radius
    med = lambda m: float(np.median(np.abs(t_rad[m]))) if np.any(m) else float("nan")
    return {
        "inner_abs_median": med(inner),
        "rim_abs_median": med(rim),
        "outer_abs_median": med(outer),
        "tilt_in_radial_max_abs": float(np.max(np.abs(t_rad))),
    }


def run_theta_optimize(minim, *, theta_initial, steps, every, delta, inner_steps):
    """Scalar theta_B coordinate descent (reference
    _run_theta_optimize_detailed, reproduce_flat_disk_one_leaflet.py:
    1129-1173): zero the tilts, then per iteration relax leaflet tilts and
    run the thetaB scan.  Returns (theta_opt, iterations_completed)."""
    import dataclasses as _dc

    import jax.numpy as jnp

    from membrane_solver_tpu.runtime import tilt_optimization as _topt

    gp = minim.mesh.global_parameters
    gp.set("tilt_thetaB_optimize", True)
    gp.set("tilt_thetaB_value", float(theta_initial))
    gp.set("tilt_thetaB_optimize_every", int(every))
    gp.set("tilt_thetaB_optimize_delta", float(delta))
    gp.set("tilt_thetaB_optimize_inner_steps", int(inner_steps))

    p = minim.problem()
    zeros = jnp.zeros_like(p.state.tilts_in)
    p.state = _dc.replace(p.state, tilts_in=zeros, tilts_out=zeros)
    tilt_mode = str(gp.get("tilt_solve_mode", "coupled") or "coupled")
    for i in range(int(steps)):
        minim.relax_leaflet_tilts()
        _topt.optimize_thetaB_scalar(minim, tilt_mode=tilt_mode, iteration=i)
    theta_opt = float(gp.get("tilt_thetaB_value") or 0.0)
    if not np.isfinite(theta_opt):
        raise ValueError("Non-finite optimized theta_B value")
    return theta_opt, int(steps)


# kh_wide optimize preset (reference _resolve_optimize_preset:138-148)
KH_WIDE = {"steps": 120, "every": 1, "delta": 2.0e-3, "inner_steps": 20}


def run_benchmark(
    *,
    fixture: str = DEFAULT_FIXTURE,
    refine_level: int = 2,
    outer_mode: str = "disabled",
    theta_min: float = 0.0,
    theta_max: float = 0.0014,
    theta_count: int = 8,
    tilt_mass_mode_in: str | None = None,
    theta_mode: str = "scan",
    optimize_preset: str = "none",
    parameterization: str = "legacy",
    smoothness_model: str = "dirichlet",
    theta_initial: float = 0.0,
) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from membrane_solver_tpu import Minimizer, load_data, parse_geometry
    from membrane_solver_tpu.runtime.refinement import (
        refine_polygonal_facets,
        refine_triangle_mesh,
    )

    theory_params = tex_reference_params()
    if parameterization == "kh_physical":
        theory = compute_flat_disk_kh_physical_theory(theory_params)
    else:
        theory = compute_flat_disk_theory(theory_params)

    mesh = parse_geometry(load_data(fixture))
    for _ in range(int(refine_level)):
        mesh = refine_triangle_mesh(refine_polygonal_facets(mesh))
    configure_benchmark_mesh(
        mesh,
        theory=theory_params,
        outer_mode=outer_mode,
        parameterization=parameterization,
        smoothness_model=smoothness_model,
    )
    if tilt_mass_mode_in is not None:
        # lumped vs consistent tilt mass discretization (reference
        # benchmarks/benchmark_flat_disk_tilt_mass_mode.py:35-57)
        mesh.global_parameters.set("tilt_mass_mode_in", str(tilt_mass_mode_in))
    minim = Minimizer(mesh, quiet=True)
    # hard geometric projection before the scan (pins move positions onto
    # their exact circles/planes; reference benchmark does this once after
    # configuring, reproduce_flat_disk_one_leaflet.py:2188-2190)
    minim.enforce_constraints_after_mesh_ops()

    qfit = None
    theta_values = np.zeros(0)
    energies = np.zeros(0)
    optimize_report = None
    if theta_mode == "optimize":
        cfg = dict(KH_WIDE)
        if optimize_preset not in ("kh_wide", "none"):
            raise ValueError("supported optimize presets: kh_wide, none")
        theta_star, iters = run_theta_optimize(minim, theta_initial=theta_initial, **cfg)
        optimize_report = {
            "theta_initial": float(theta_initial),
            "optimize_preset_effective": str(optimize_preset),
            "optimize_iterations_completed": iters,
            **{f"optimize_{k}": v for k, v in cfg.items()},
            "theta_star_raw": float(theta_star),
        }
    else:
        theta_values = np.linspace(theta_min, theta_max, theta_count)
        energies = np.array(
            [
                run_theta_relaxation(minim, theta_value=float(t), reset_outer=True)
                for t in theta_values
            ]
        )
        min_idx = int(np.argmin(energies))
        if min_idx in (0, len(theta_values) - 1):
            raise ValueError("scan minimum on the bracket boundary; widen the scan")
        qfit = quadratic_min_from_scan(
            theta_values[min_idx - 1 : min_idx + 2], energies[min_idx - 1 : min_idx + 2]
        )
        theta_star = qfit["theta_star"]

    total_energy = run_theta_relaxation(minim, theta_value=theta_star, reset_outer=True)
    p = minim.problem()
    nv = p.n_vertices
    pos = np.asarray(p.state.positions[:nv])
    z_span = float(np.ptp(pos[:, 2]))
    profile = radial_profile_metrics(minim, float(theory_params.radius))

    tout = np.asarray(p.state.tilts_out[:nv])
    free_out = ~np.asarray(p.topo.tilt_fixed_out_mask[:nv])
    outer_max = float(np.max(np.linalg.norm(tout[free_out], axis=1))) if free_out.any() else 0.0

    probe_before = 0.0
    probe_after = 0.0
    if outer_mode == "free" and free_out.any():
        # outer decay probe: seeded noise must decay under a conservative
        # relaxation (reference run_flat_disk_one_leaflet_benchmark)
        import dataclasses as _dc

        import jax.numpy as jnp

        rng = np.random.default_rng(12345)
        t_probe = np.asarray(p.state.tilts_out).copy()
        rows = np.flatnonzero(free_out)
        t_probe[rows] += 1e-3 * rng.standard_normal((rows.size, 3))
        p.state = _dc.replace(p.state, tilts_out=jnp.asarray(t_probe))
        probe_before = float(np.max(np.linalg.norm(t_probe[rows], axis=1)))
        minim.relax_leaflet_tilts(max_iters=600, step_size=1e-3)
        p = minim.problem()
        probe_after = float(
            np.max(np.linalg.norm(np.asarray(p.state.tilts_out[:nv])[rows], axis=1))
        )

    report = {
        "meta": {
            "fixture": str(fixture),
            "refine_level": int(refine_level),
            "outer_mode": outer_mode,
            "theory_source": (
                "kh_physical_radial_integral"
                if parameterization == "kh_physical"
                else "docs/tex/1_disk_flat.tex"
            ),
            "theta_mode": str(theta_mode),
            "parameterization": str(parameterization),
            "smoothness_model": str(smoothness_model),
            "theta_min": float(theta_min),
            "theta_max": float(theta_max),
            "theta_count": int(theta_count),
        },
        "metrics": {
            "theory": {
                k: theory[k]
                for k in (
                    "lambda_value",
                    "lambda_inverse",
                    "lambda_radius",
                    "ratio_i1_i0",
                    "ratio_k1_k0",
                    "coeff_A",
                    "coeff_B",
                    "theta_star",
                    "total",
                )
            },
            "mesh": {
                "theta_star": float(theta_star),
                "total_energy": float(total_energy),
                "planarity_z_span": z_span,
                "outer_tilt_max_free_rows": outer_max,
                "outer_decay_probe_max_before": probe_before,
                "outer_decay_probe_max_after": probe_after,
                "profile": {
                    "rim_abs_median": profile["rim_abs_median"],
                    "outer_abs_median": profile["outer_abs_median"],
                },
            },
            "parity": {
                # symmetric factor difference >= 1 (reference
                # _factor_difference: max(m/t, t/m))
                "theta_factor": _factor_difference(theta_star, theory["theta_star"]),
                "energy_factor": _factor_difference(total_energy, theory["total"]),
            },
        },
        "scan": {
            "theta_values": theta_values.tolist(),
            "energy_values": energies.tolist(),
            "local_quadratic_fit": qfit,
        },
        "optimize": optimize_report,
    }
    return report


def compare_to_baseline(report: dict, baseline_path: str) -> list[str]:
    """Field-by-field comparison against a recorded reference baseline."""
    import yaml

    base = yaml.safe_load(open(baseline_path))
    failures: list[str] = []

    def walk(ref, got, tols, prefix=""):
        for key, ref_val in ref.items():
            path = f"{prefix}{key}"
            if isinstance(ref_val, dict):
                walk(ref_val, got.get(key, {}), tols.get(key, {}), path + ".")
                continue
            tol = tols.get(key)
            got_val = got.get(key)
            if got_val is None or tol is None:
                continue
            if abs(float(got_val) - float(ref_val)) > float(tol):
                failures.append(
                    f"{path}: got {got_val!r}, baseline {ref_val!r}, tol {tol!r}"
                )

    walk(base.get("metrics", {}), report["metrics"], base.get("tolerances", {}))
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fixture", default=DEFAULT_FIXTURE)
    ap.add_argument("--refine-level", type=int, default=2)
    ap.add_argument("--outer-mode", choices=("disabled", "free"), default="disabled")
    ap.add_argument("--theta-min", type=float, default=0.0)
    ap.add_argument("--theta-max", type=float, default=0.0014)
    ap.add_argument("--theta-count", type=int, default=8)
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)

    report = run_benchmark(
        fixture=args.fixture,
        refine_level=args.refine_level,
        outer_mode=args.outer_mode,
        theta_min=args.theta_min,
        theta_max=args.theta_max,
        theta_count=args.theta_count,
    )
    text = json.dumps(report, indent=1)
    if args.output:
        Path(args.output).write_text(text)
    print(text)
    if args.baseline:
        failures = compare_to_baseline(report, args.baseline)
        if failures:
            print("BASELINE MISMATCHES:")
            for f in failures:
                print("  " + f)
            return 1
        print("baseline comparison OK:", args.baseline)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
