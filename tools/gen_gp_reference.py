#!/usr/bin/env python
"""Generate docs/PARAMETERS.md — the global-parameter / option reference.

The reference ships a 1,262-line user manual; this repo's operator surface
is documented by scanning the SOURCE for every honored key (so the table
can never silently go stale) and merging curated one-line descriptions.
A test (tests/test_manual_coverage.py) re-runs the scan and fails if a key
in code is missing from the generated doc, or a described key vanished
from code.

    python tools/gen_gp_reference.py        # rewrites docs/PARAMETERS.md
"""

from __future__ import annotations

import re
import sys
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "membrane_solver_tpu"
OUT = REPO / "docs" / "PARAMETERS.md"

_GP_PAT = re.compile(
    r"(?:params|gp|global_parameters)\.get\(\s*['\"]([a-zA-Z_0-9]+)['\"]"
    r"|spec\.option\(\s*['\"]([a-zA-Z_0-9]+)['\"]"
)
_OPT_PAT = re.compile(r"(?:opts|options)\.get\(\s*['\"]([a-zA-Z_0-9]+)['\"]")
_DEFAULT_PAT = re.compile(
    r"(?:params|gp|global_parameters)\.get\(\s*['\"]{key}['\"]\s*,\s*([^()]+?)\)"
    r"|spec\.option\(\s*['\"]{key}['\"]\s*,\s*([^()]+?)\)"
)


def scan_keys():
    """(gp_keys, opt_keys): key -> sorted list of repo-relative call sites."""
    gp: dict[str, set] = defaultdict(set)
    opt: dict[str, set] = defaultdict(set)
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO)
        text = path.read_text()
        for m in _GP_PAT.finditer(text):
            key = m.group(1) or m.group(2)
            gp[key].add(str(rel))
        for m in _OPT_PAT.finditer(text):
            opt[m.group(1)].add(str(rel))
    return gp, opt


def scan_default(key: str) -> str:
    pat = re.compile(
        r"(?:params|gp|global_parameters)\.get\(\s*['\"]" + key + r"['\"]\s*,\s*([^()\n]+?)\)"
        r"|spec\.option\(\s*['\"]" + key + r"['\"]\s*,\s*([^()\n]+?)\)"
    )
    seen = []
    for path in sorted(PKG.rglob("*.py")):
        for m in pat.finditer(path.read_text()):
            raw = (m.group(1) or m.group(2) or "").strip()
            raw = re.sub(r"jnp\.asarray\(|jnp\.float64|,\s*dtype\)?|dtype=\w+", "", raw).strip(" ,")
            if raw and raw not in seen:
                seen.append(raw)
    return seen[0] if seen else "—"


# ---------------------------------------------------------------------------
# Curated one-line descriptions.  Grouped for the doc; every key the scan
# finds MUST appear here (the generator exits non-zero otherwise).
# ---------------------------------------------------------------------------

GP_SECTIONS: dict[str, dict[str, str]] = {
    "Core energies and moduli": {
        "surface_tension": "Surface-tension coefficient γ in E = γ·ΣA (per-facet override via facet options).",
        "bending_modulus": "Helfrich bending modulus κ for the bending / bending_tilt families (bilayer value; per-leaflet keys override).",
        "bending_modulus_in": "Inner-leaflet bending modulus; falls back to `bending_modulus`.",
        "bending_modulus_out": "Outer-leaflet bending modulus; falls back to `bending_modulus`.",
        "bending_energy_model": "`helfrich` (½κ(2H−c₀)²A) or `willmore` (κH²A) for the `bending` module.",
        "spontaneous_curvature": "Spontaneous curvature c₀ in the Helfrich term (alias: `intrinsic_curvature`).",
        "intrinsic_curvature": "Alias of `spontaneous_curvature` (reference compatibility).",
        "gaussian_modulus": "Gaussian (saddle-splay) modulus κ̄ for the `gaussian_curvature` module.",
        "line_tension": "Line tension per unit length on tagged edges (`line_tension` energy module).",
        "edge_stiffness": "Quadratic edge-length penalty stiffness (`edge_length_penalty` module).",
        "area_stiffness": "Soft body-surface-area penalty stiffness (`body_area_penalty` module).",
        "target_surface_area": "Target for the soft/hard global-area machinery (global_area constraint, body_area_penalty).",
        "jordan_stiffness": "Stiffness of the planar shoelace-area penalty (`jordan_area` module).",
        "jordan_target_area": "Target signed xy-area for `jordan_area`.",
        "volume_stiffness": "Soft volume-penalty stiffness k in ½k(V−V₀)² (only in `penalty` volume mode).",
        "volume_constraint_mode": "`lagrange` (hard KKT + geometric projection) or `penalty` (soft energy) body-volume handling.",
        "volume_projection_during_minimization": "Re-project body volume geometrically when drift exceeds `volume_tolerance` mid-run.",
        "volume_tolerance": "Allowed abs(V−V₀) drift before the hard volume projection re-runs.",
        "perimeter_constraints": "Declarations of signed-edge-loop perimeter conservation groups (perimeter constraint module).",
    },
    "Tilt energies and moduli": {
        "tilt_modulus": "Tilt-magnitude penalty modulus k_t for the single-field `tilt` module.",
        "tilt_modulus_in": "Inner-leaflet tilt modulus (`tilt_in`).",
        "tilt_modulus_out": "Outer-leaflet tilt modulus (`tilt_out`).",
        "tilt_rigidity": "Legacy alias used by the single-field tilt module when `tilt_modulus` is unset.",
        "tilt_smoothness_modulus": "Dirichlet (cotan) tilt-smoothness modulus k_s, all tilt_smoothness variants.",
        "tilt_twist_modulus": "Twist modulus of the Kozlov–Hamm splay/twist split (`tilt_splay_twist_in`).",
        "tilt_coupling_modulus": "Inter-leaflet coupling modulus k_c (`tilt_coupling`).",
        "tilt_coupling_mode": "`difference` (t_out−t_in) or `sum` coupling in `tilt_coupling`.",
        "tilt_couping_mode": "Misspelled legacy alias of `tilt_coupling_mode` accepted for reference compatibility.",
        "tilt_smoothness_rigidity": "Legacy alias of `tilt_smoothness_modulus` (reference compatibility).",
        "tilt_splay_modulus_in": "Splay modulus of the Kozlov–Hamm split; falls back to bending_modulus_in → bending_modulus.",
        "tilt_twist_modulus_in": "Inner-leaflet twist modulus; falls back to `tilt_twist_modulus`.",
        "tilt_mass_mode": "Tilt-magnitude mass matrix: `lumped` (barycentric row sums) or `consistent`.",
        "tilt_divergence_mode": "P1 divergence transport model for tilt operators (`ambient_v1` or `connection_v1`).",
        "tilt_divergence_mode_in": "Inner-leaflet override of `tilt_divergence_mode`.",
        "tilt_transport_model": "Tangent-transport model for smoothness/divergence (`ambient_v1` | `connection_v1`).",
    },
    "Bending–tilt coupling (Kozlov caveolin lanes)": {
        "bending_tilt_base_term_reference_mode": "How the 2H−c₀ base term is referenced in the coupled energy (lane-specific ablation).",
        "bending_tilt_base_term_region_mode": "Restrict the coupled base term to a radial region (`off` | region modes).",
        "bending_tilt_base_term_region_radius": "Radius for `bending_tilt_base_term_region_mode`.",
        "bending_tilt_assume_J0_presets": "Preset names whose rows assume zero base curvature (J₀) in the coupled term.",
        "bending_tilt_assume_J0_presets_radius_max": "Radial cutoff for the assume-J0 preset rows.",
        "bending_tilt_in_update_mode": "Inner-leaflet gradient ablations: `radial_cross_term_off_v1` (value-preserving) or `outer_near_divergence_cap_v1` (straight-through clip).",
        "bending_tilt_interface_divergence_mode": "`trace_reconstructed_v1`: straight-through source-mean divergence reconstruction on trace triangles (inner).",
        "bending_tilt_interface_divergence_mode_out": "Outer-leaflet interface divergence mode (alias spelling).",
        "bending_tilt_out_interface_divergence_mode": "Outer-leaflet interface divergence mode.",
        "bending_tilt_in_scaffold_shape_stencil_mode": "`trace_boundary_v1`: stop the z shape-gradient on scaffold trace rows.",
    },
    "Rim sources, disk contact, θ_B": {
        "tilt_rim_source_center": "Center of the disk-rim source ring (xyz).",
        "tilt_rim_source_edge_mode": "Which rim edges receive the source term.",
        "tilt_disk_contact_center": "Disk center for the contact-work term F_cont.",
        "tilt_disk_contact_normal": "Disk plane normal for contact geometry.",
        "tilt_disk_contact_group_in": "Vertex group receiving the inner-leaflet disk-contact term.",
        "tilt_disk_contact_strength_in": "Contact strength (direct, or derived when `tilt_disk_contact_units` is physical).",
        "tilt_disk_contact_units": "`model` (direct strengths) or physical-unit mode via the Kozlov/Barnoy contact mapping.",
        "tilt_disk_contact_length_unit_m": "Meters per model length unit for the physical contact mapping.",
        "tilt_disk_contact_kappa_ref_J": "Physical reference bending modulus (J) for the contact mapping.",
        "tilt_thetaB_value": "Boundary tilt angle θ_B (the scalar DOF of the contact lanes).",
        "tilt_thetaB_group_in": "Vertex group whose rows carry the θ_B boundary condition.",
        "tilt_thetaB_center": "Center used to build the radial θ_B boundary direction.",
        "tilt_thetaB_normal": "Normal of the θ_B boundary plane.",
        "tilt_thetaB_strength_in": "Strength of the hard θ_B boundary enforcement rows.",
        "tilt_thetaB_contact_strength_in": "Strength of the θ_B contact work term (tilt_thetaB_contact_in).",
        "tilt_thetaB_contact_work_mode": "Contact-work form of the θ_B scalar term.",
        "tilt_thetaB_contact_penalty_mode": "Penalty form selector for the θ_B contact term.",
        "tilt_thetaB_optimize": "Treat θ_B as a globally optimized scalar (scan) instead of the closed-form update.",
        "tilt_thetaB_optimize_every": "Scan θ_B every N outer iterations.",
        "tilt_thetaB_optimize_delta": "Scan step δ for the θ_B candidates {θ, θ±δ}.",
        "tilt_thetaB_optimize_inner_steps": "Reduced inner-relax budget for each θ_B scan probe.",
        "tilt_axisymmetric_about_thetaB_center": "Axisymmetrically project tilts about the θ_B center during relaxation.",
    },
    "Rim slope matching (hard kinematic rim)": {
        "rim_slope_match_mode": "`pointwise_radial_v1` | `ring_average_radial_v1` | `shared_rim_staggered_v1` | `physical_edge_staggered_v1`.",
        "rim_slope_match_group": "Rim vertex group tag.",
        "rim_slope_match_disk_group": "Disk-side group for the inner relation.",
        "rim_slope_match_outer_group": "Outer-membrane group for the slope side.",
        "rim_slope_match_center": "Rim circle center.",
        "rim_slope_match_normal": "Rim plane normal.",
        "rim_slope_match_strength": "Penalty strength for the energy (γ>0) form; 0 = hard kinematic constraint.",
        "rim_slope_match_kkt_rows": "`default` or `reference_exact` (faithfully skip the reference's singular joint KKT; parity replays).",
        "rim_slope_match_thetaB_param": "Which θ parameter the matching relation reads.",
        "rim_slope_match_scaffold_projector_mode": "Scaffold-trace projector: `proximal` or `continuity_v2`.",
        "rim_slope_match_scaffold_mesh_operation_mode": "`preserve_trace_v1`: skip mesh ops on scaffold trace shells.",
        "parity_trace_layer_radius": "Scaffold-trace lane: radius of the traced shell layer.",
        "parity_outer_shells": "Scaffold-trace lane: number of outer shells held by the trace.",
        "shape_scaffold_rejected_step_fallback": "`trace_z_v1`: after a failed shape step, take the scaffold trace-z fallback direction.",
        "curved_local_interface_match_mode": "Matching mode of the curved local-interface hard constraint family.",
        "curved_theta_objective_ablation_mode": "Per-module energy rescale ablation for curved-θ objectives (with _inner/_outer/_contact scales).",
        "benchmark_geometry_lane": "Named geometry lane for benchmark-specific parameterizations.",
        "benchmark_parameterization": "Benchmark parameterization selector (e.g. `kh_physical`).",
        "benchmark_disk_radius": "Disk radius used by the radial-continuation inner-coupled update cap.",
        "benchmark_lambda_value": "λ value for the radial-continuation cap.",
        "inner_coupled_update_mode": "`rim_matched_radial_continuation_v1`: cap inner-tilt radial deltas during coupled updates.",
        "theory_parity_lane": "Lane label recorded into theory-parity reports.",
    },
    "Outer-leaflet absence / interface validation": {
        "leaflet_out_absence_mode": "How outer-leaflet-absent regions are masked (disk lanes).",
        "leaflet_out_absent_presets": "Preset names whose triangles have no outer leaflet.",
        "disk_interface_validate": "Validate disk interface topology at minimize() start.",
        "tilt_in_shared_rim_outer_row_energy_weight": "Weight of shared-rim outer rows in the inner tilt energy (with the exclude-shared-rim row options).",
    },
    "Constraint module geometry": {
        "pin_to_circle_mode": "`fixed` | `fit` (circle translates/rotates to best fit) pin-to-circle behavior.",
        "pin_to_circle_mesh_operation_preserve_normal_groups": "Pin groups whose circle normal is preserved through mesh operations.",
        "pin_to_circle_point": "Circle center point (global default; per-vertex options override).",
        "pin_to_plane_mode": "`fixed` | `slide` | `fit` pin-to-plane behavior.",
        "pin_to_plane_normal": "Plane normal (global default).",
        "pin_to_plane_point": "Plane point (global default).",
        "fixed_plane_normal": "Normal of the `fixed_plane` constraint.",
        "fixed_plane_point": "Point of the `fixed_plane` constraint.",
        "rigid_disk_group": "Vertex group forming the rigid disk patch.",
        "rigid_disk_radius": "Rigid disk radius.",
        "rigid_disk_rim_group": "Rim group attached to the rigid disk.",
        "tilt_vector_match_mode": "Mode of the hard in-plane tilt continuity across the rim (tilt_vector_match_rim).",
        "tilt_leaflet_match_mode": "Mode of the per-leaflet rim tilt matching (tilt_leaflet_match_rim).",
        "tilt_leaflet_match_group": "Vertex group for per-leaflet rim tilt matching.",
    },
    "Minimizer / optimizer": {
        "step_size": "Initial (or fixed) Armijo line-search step size.",
        "step_size_mode": "`adaptive` (Armijo growth/backtracking carries across steps) or `fixed`.",
        "step_size_floor": "Step size below which repeated zero-steps terminate the run early.",
        "max_zero_steps": "Consecutive failed steps at the floor before early termination.",
        "line_search_reduced_accept_rule": "`armijo` or `decrease_only` accept rule for the reduced (tilt-relax-inside) line search.",
        "line_search_reduced_energy": "`on`: line-search trials re-relax the leaflet tilts inside the trial energy (reduced mode).",
        "line_search_reduced_tilt_inner_steps": "Inner-relax budget for each reduced line-search trial.",
        "mesh_quality_auto_repair_enabled": "Run the automatic equiangulation repair inside minimize().",
        "mesh_quality_auto_repair_every": "Repair cadence in outer steps (default 50).",
        "mesh_quality_aspect_threshold": "p-percentile triangle aspect ratio that triggers repair (default 3.0).",
        "mesh_quality_aspect_percentile": "Percentile used for the aspect trigger (default 90).",
        "mesh_quality_max_repair_passes": "Bounded equiangulation passes per repair.",
        "gauss_bonnet_monitor": "Track the Gauss–Bonnet invariant drift every step.",
        "gauss_bonnet_c1": "Gauss–Bonnet drift tolerance scale c1 (√N·ε law).",
        "gauss_bonnet_c2": "Gauss–Bonnet drift tolerance scale c2.",
        "gauss_bonnet_eps_angle": "Angle epsilon for the Gauss–Bonnet boundary sums.",
        "gaussian_curvature_check_defects": "Verify angle-defect topology when evaluating gaussian_curvature.",
        "gaussian_curvature_strict_topology": "Raise on malformed topology instead of warning.",
        "gaussian_curvature_defect_tol": "Tolerance of the defect-sum topology check.",
    },
    "Tilt inner solve": {
        "tilt_solve_mode": "`nested` or `coupled` ordering of the tilt inner solve vs shape steps.",
        "tilt_solver": "`cg` (Jacobi-preconditioned Polak–Ribière) or `gd` inner tilt solver.",
        "tilt_inner_steps": "Inner tilt iterations per outer step (alias of `tilt_cg_max_iters`).",
        "tilt_cg_max_iters": "Hard cap of inner CG iterations (trumps `tilt_inner_steps` when set).",
        "tilt_step_size": "Initial inner tilt step (backtracked up to 12 halvings per trial).",
        "tilt_tol": "Projected-gradient-norm convergence tolerance of the inner solve (0 = off).",
        "tilt_coupled_steps": "Coupled-mode inner repetitions per outer iteration.",
        "tilt_cg_preconditioner": "`jacobi` (tilt modulus × areas + smoothness row sums) or `none`.",
        "tilt_cg_rejection_fallback": "`gd`: retry a rejected CG direction with steepest descent before giving up.",
        "tilt_projection_cadence": "`per_step` (refresh constraints after accepted inner steps) or `per_pass`.",
        "tilt_projection_interval": "Accepted-step interval of the per_step constraint refresh.",
        "tilt_guard": "`on`: enable the relax energy-spike guard (rollback + step halving).",
        "tilt_relax_energy_guard_factor": "Spike threshold factor: rollback when post-relax E exceeds max(guard_min, abs(E)·factor).",
        "tilt_relax_energy_guard_min": "Absolute floor of the spike threshold.",
        "tilt_relax_energy_guard_retries": "Halved-step retries before the relax is fully rolled back (default 4).",
        "tilt_axisym": "`on`: axisymmetric tilt projection about the configured center.",
    },
}

OPT_DESCRIPTIONS: dict[str, str] = {
    "preset": "Named per-vertex/facet preset (e.g. `disk`, `rim`) driving tags, absence masks and inheritance.",
    "fixed": "(bool) vertex position is frozen; gradient rows are zeroed.",
    "energy": "Per-entity extra energy module list (entity-scoped energies).",
    "constraint_expression": "Hard per-vertex expression constraint (safe-eval AST).",
    "constraint_target": "Target value of the per-vertex expression constraint.",
    "expression_constraint": "Alias of `constraint_expression`.",
    "expression_target": "Alias of `constraint_target`.",
    "target_area": "Per-facet hard area target (`fix_facet_area`).",
    "area_target": "Alias of `target_area`.",
    "area_stiffness": "Per-entity soft-area stiffness override.",
    "target_length": "Per-edge target length (edge_length_penalty).",
    "spontaneous_curvature": "Per-vertex c₀ override.",
    "intrinsic_curvature": "Per-vertex c₀ override (alias).",
    "disk_tag": "Disk patch tag (multi-disk observables / analysis grouping).",
    "rigid_disk_group": "Membership in a rigid-disk transform group.",
    "pin_to_circle_group": "Pin-to-circle constraint group (with radius/normal/point/mode options).",
    "rim_slope_match_group": "Rim-matching group membership (`rim`).",
    "tilt_thetaB_group": "θ_B boundary group membership (single-field).",
    "tilt_thetaB_group_in": "θ_B boundary group membership (inner leaflet).",
    "tilt_disk_contact_group": "Disk-contact group membership.",
    "tilt_vector_match_group": "Rim tilt-continuity group membership.",
    "tilt_vector_match_role": "`disk` or `outer` side of the rim tilt-continuity pair.",
    "outer_shell_scaffold_index": "Scaffold-trace shell index carried by trace vertices.",
    "outer_shell_release_ring": "Ring marker releasing a scaffold shell during the gapfill lane.",
    "constraints": "List of constraint-module names attached to the entity.",
    "energy_expression": "Per-entity expression-energy formula (safe-eval AST over coordinates/measures).",
    "expression": "Expression body for the expression energy/constraint modules.",
    "expr": "Alias of `expression`.",
    "no_refine": "(bool) exclude the facet/edge from triangle refinement.",
    "surface_tension": "Per-facet γ override of the global surface tension.",
    "target_volume": "Per-body hard/soft volume target V₀.",
    "tilt": "Initial per-vertex tilt vector (single field).",
    "tilt_in": "Initial inner-leaflet tilt vector.",
    "tilt_out": "Initial outer-leaflet tilt vector.",
}


def main() -> int:
    gp, opt = scan_keys()
    described = {k for sec in GP_SECTIONS.values() for k in sec}
    missing = sorted(set(gp) - described)
    stale = sorted(described - set(gp))
    if missing:
        print("UNDOCUMENTED gp keys (add to GP_SECTIONS):", missing, file=sys.stderr)
        return 1
    if stale:
        print("STALE described keys (no longer in code):", stale, file=sys.stderr)
        return 1
    opt_missing = sorted(set(opt) - set(OPT_DESCRIPTIONS))
    if opt_missing:
        print("UNDOCUMENTED option keys:", opt_missing, file=sys.stderr)
        return 1

    lines = [
        "# Global parameters & per-entity options",
        "",
        "<!-- GENERATED by tools/gen_gp_reference.py — edit the descriptions there, not here. -->",
        "",
        "Every key below is honored by the solver core (the table is generated",
        "by scanning the source; tests/test_manual_coverage.py pins it against",
        "the code).  Global parameters come from code defaults, overridden by",
        "the input file's `global_parameters:` block and `defines:`, mutable at",
        "runtime with the `set` command.  Per-entity options live in each",
        "vertex/edge/facet/body's `options` dict with `ParameterResolver`",
        "fallback to the globals.  See docs/MANUAL.md for the command language",
        "and input schema.",
        "",
        f"Scanned keys: {len(gp)} global parameters, {len(opt)} per-entity options.",
        "",
    ]
    for section, keys in GP_SECTIONS.items():
        lines += [f"## {section}", "", "| Key | Default | Meaning | Read by |", "|---|---|---|---|"]
        for key in sorted(keys):
            if key not in gp:
                continue
            sites = ", ".join(
                sorted({Path(s).name for s in gp[key]})[:3]
            )
            default = scan_default(key).replace("|", "\\|")
            lines.append(f"| `{key}` | `{default}` | {keys[key]} | {sites} |")
        lines.append("")

    lines += [
        "## Per-entity options",
        "",
        "| Option | Meaning |",
        "|---|---|",
    ]
    for key in sorted(opt):
        lines.append(f"| `{key}` | {OPT_DESCRIPTIONS[key]} |")
    lines += [
        "",
        "Constraint-module attachment options (`constraints: [...]` lists plus",
        "module-specific keys like `pin_to_circle_radius`, `pin_to_plane_normal`,",
        "`rim_slope_match_group`) follow the reference's schema; see each module",
        "docstring under `membrane_solver_tpu/constraints/` for the per-module",
        "file:line parity citation.",
        "",
        "## Environment variables",
        "",
        "| Variable | Meaning |",
        "|---|---|",
        "| `MEMBRANE_SOLVER_X64` | `1` (default) = float64 everywhere (reference parity); `0` = float32. |",
        "| `MEMBRANE_SOLVER_COMPILE_CACHE` | `1` (default) persistent XLA cache in `JAX_COMPILATION_CACHE_DIR`, else `<checkout>/.jax_cache`; `0` off. |",
        "| `MEMBRANE_SOLVER_AOT_CACHE` | `1` (default) flat-leaves AOT export cache under `<compile cache>/aot` for fast process warm starts; `0` off. |",
        "| `MEMBRANE_SOLVER_AOT_VALIDATE` | `1`: recompile-and-compare every AOT cache load (paranoia mode). |",
        "",
    ]
    OUT.write_text("\n".join(lines))
    print(f"wrote {OUT} ({len(gp)} gp keys, {len(opt)} option keys)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
