"""In-jit leaflet tilt relaxation (nested/coupled inner solves).

Parity: reference ``runtime/steppers/tilt_relaxation.py:relax_leaflet_tilts``
(426-1470) — with positions frozen:

1. enforce tilt constraints, load tilts, tangent-project;
2. evaluate tilt-dependent energy + tilt gradients for both leaflets, project
   the gradients against the stacked tilt-constraint rows (KKT), zero fixed
   rows;
3. GD: backtracking (12 halvings from tilt_step_size) on
   tangent-projected trials with fixed-row overrides, accept when E1 <= E0;
   CG: preconditioned (Jacobi) Polak-style loop with the same backtracking,
   per-accepted-step constraint refresh, beta = rz_new / rz_old;
4. stop on zero gradient, tol convergence, rejection, or max iters.

Everything runs as fixed-shape lax loops on device; the Jacobi preconditioner
follows runtime/preconditioners.py:64-146 (tilt-modulus mass + bending-modulus
cotan row sums).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import jax

import jax.numpy as jnp

from membrane_solver_tpu.device import geo as dgeo
from membrane_solver_tpu.device import linalg as dlinalg
from membrane_solver_tpu.device.state import MeshState, ProblemSpec, Topology
from membrane_solver_tpu.energy import get_module

MAX_BACKTRACKS = 12
STEP_FLOOR = 1e-16


def spec_uses_leaflet_tilts(spec: ProblemSpec) -> bool:
    return any(
        getattr(get_module(name), "USES_TILT_LEAFLETS", False)
        for name in spec.energy_modules
    )


def spec_uses_vertex_tilts(spec: ProblemSpec) -> bool:
    return any(
        getattr(get_module(name), "USES_TILT", False) for name in spec.energy_modules
    )


def make_tilt_energy(spec: ProblemSpec) -> Callable:
    """Tilt-dependent total energy (shape-only modules excluded).

    Parity: EvaluationManager.compute_tilt_dependent_energy_with_leaflet_tilts
    (evaluation_manager.py:557-742) — the accept/reject comparisons during the
    inner solve only involve tilt-dependent modules.
    """
    from membrane_solver_tpu.runtime.jit_core import active_energy_modules

    fns = []
    for name in active_energy_modules(spec):
        module = get_module(name)
        if not (
            getattr(module, "USES_TILT", False)
            or getattr(module, "USES_TILT_LEAFLETS", False)
        ):
            continue
        # prefer the module's in-loop objective when it differs from the
        # clean energy: the reference's relax routes tilt_in/tilt_out through
        # the evaluation manager's lumped magnitude fast path
        # (evaluation_manager.py:561-575, 658-691), bypassing consistent
        # mass and row weights that the clean scorer honors
        maker = getattr(module, "make_inloop_energy", None) or getattr(
            module, "make_energy", None
        )
        from membrane_solver_tpu.runtime.jit_core import module_scale_fn

        fns.append(
            (maker(spec) if maker is not None else module.energy,
             module_scale_fn(spec, name))
        )

    def tilt_energy(state: MeshState, topo: Topology, params: Dict):
        geo = dgeo.triangle_geometry(state.positions, topo.tri_rows, topo.tri_valid)
        dtype = state.positions.dtype
        e = jnp.asarray(0.0, dtype)
        for fn, sc in fns:
            term = fn(geo, state, topo, params)
            if sc is not None:
                term = sc(params, dtype) * term
            e = e + term
        return e

    # jit: trace the tilt-energy graph once per abstract signature
    return jax.jit(tilt_energy)


def make_inner_coupled_delta_cap(positions, topo, params, fixed_in):
    """Benchmark-only continuation cap on inner trial deltas.

    Parity: reference tilt_relaxation.py:48-114
    (_apply_inner_coupled_update_mode_to_delta): rows in the near band
    (radius+lam, radius+4*lam] clip their radial delta components to
    1.05x the median |radial delta| over the rim band |r-radius| <= lam;
    inactive when radius/lambda are unset, either band is empty, or the
    cap is non-positive.  The masks are position-only (positions are
    frozen for the whole relax call).
    """
    dtype = positions.dtype
    cc = topo.extras["core:inner_coupled/center_xy"].astype(dtype)
    radius_b = params.get("benchmark_disk_radius", jnp.asarray(0.0, dtype))
    lam_b = params.get("benchmark_lambda_value", jnp.asarray(0.0, dtype))
    shifted = positions.at[:, 0].add(-cc[0]).at[:, 1].add(-cc[1])
    radii = jnp.linalg.norm(shifted[:, :2], axis=1)
    rgood = radii > 1e-12
    rh = jnp.zeros_like(positions)
    rh = rh.at[:, 0].set(jnp.where(rgood, shifted[:, 0] / jnp.maximum(radii, 1e-12), 0.0))
    rh = rh.at[:, 1].set(jnp.where(rgood, shifted[:, 1] / jnp.maximum(radii, 1e-12), 0.0))
    free_in = topo.vertex_valid & ~fixed_in
    rim_m = (jnp.abs(radii - radius_b) <= lam_b) & free_in
    target_m = (
        (radii > radius_b + lam_b) & (radii <= radius_b + 4.0 * lam_b) & free_in
    )
    active = (radius_b > 0.0) & (lam_b > 0.0) & jnp.any(rim_m) & jnp.any(target_m)

    def _masked_median_abs(vals, mask):
        # np.median over the masked subset: sort with +inf padding, average
        # the two middle elements of the n live entries
        v = jnp.where(mask, jnp.abs(vals), jnp.inf)
        v = jnp.sort(v)
        n = jnp.sum(mask.astype(jnp.int32))
        lo = jnp.maximum((n - 1) // 2, 0)
        hi = jnp.maximum(n // 2, 0)
        med = 0.5 * (v[lo] + v[hi])
        return jnp.where(n > 0, med, 0.0)

    def apply_delta_cap(delta_in):
        rad = jnp.sum(delta_in * rh, axis=1)
        cap = 1.05 * _masked_median_abs(rad, rim_m)
        capped = jnp.clip(rad, -cap, cap)
        adjust = jnp.where(target_m, capped - rad, 0.0)
        adjust = jnp.where(jnp.abs(adjust) > 1.0e-14, adjust, 0.0)
        out = delta_in + adjust[:, None] * rh
        return jnp.where(active & (cap > 0.0), out, delta_in)

    return apply_delta_cap


def make_tilt_constraint_rows(spec: ProblemSpec) -> Callable:
    """Stacked (k, 2, Nv, 3) tilt-constraint gradient row pairs across modules."""
    from membrane_solver_tpu.constraints import get_constraint

    builders = []
    for name in dict.fromkeys(spec.constraint_modules):
        mod = get_constraint(name)
        maker = getattr(mod, "make_tilt_constraint_rows", None)
        if maker is not None:
            builders.append(maker(spec))

    def rows(state, topo, params):
        blocks = [b for b in (fn(state, topo, params) for fn in builders) if b is not None]
        if not blocks:
            return None
        return jnp.concatenate(blocks, axis=0)

    return rows


_TILT_ENFORCER_CACHE: dict = {}


def make_tilt_enforcer(spec: ProblemSpec) -> Callable:
    """Kinematic tilt-constraint projection across modules (enforce_tilt_constraints)."""
    if spec in _TILT_ENFORCER_CACHE:
        return _TILT_ENFORCER_CACHE[spec]
    from membrane_solver_tpu.constraints import get_constraint

    fns = []
    for name in dict.fromkeys(spec.constraint_modules):
        mod = get_constraint(name)
        maker = getattr(mod, "make_enforce_tilts", None)
        fn = maker(spec) if maker is not None else getattr(mod, "enforce_tilts", None)
        if fn is not None:
            fns.append(fn)

    def enforce(state, topo, params):
        for fn in fns:
            state = fn(state, topo, params)
        return state

    # jit: the eager per-module projection dispatched many tiny device ops
    # per call, whose launch latency dominated small lanes
    _TILT_ENFORCER_CACHE[spec] = jax.jit(enforce)
    return _TILT_ENFORCER_CACHE[spec]


def make_tilt_projector(rows):
    """Build a reusable KKT projector from fixed tilt-constraint rows.

    The rows depend only on vertex positions, which are frozen for the whole
    inner tilt solve — so the normal-equation matrix is factored ONCE and
    every iteration pays only two triangular solves (the reference likewise
    caches its sparse projection operators per relax call,
    tilt_relaxation.py:562-585).  On CPU the factor/solve pair is LAPACK
    getrf/getrs — bit-identical to the per-iteration np.linalg.solve it
    replaces.
    """
    if rows is None:
        return lambda gin, gout: (gin, gout)
    k = rows.shape[0]
    G = rows.reshape(k, -1)
    A = G @ G.T + 1e-18 * jnp.eye(k, dtype=G.dtype)
    solver = dlinalg.make_dense_solver(A)

    def project(gin, gout):
        g = jnp.concatenate([gin.reshape(-1), gout.reshape(-1)])
        lam = solver(G @ g)
        g = g - lam @ G
        n = gin.size
        return g[:n].reshape(gin.shape), g[n:].reshape(gout.shape)

    return project


def project_tilt_gradients_kkt(gin, gout, rows):
    """Project the stacked leaflet gradient against tilt-constraint rows.

    Parity: constraint_manager.apply_tilt_gradient_modifications_array
    (651-825): joint KKT over the concatenated (in, out) tilt DOFs.
    """
    return make_tilt_projector(rows)(gin, gout)


def make_compact_tilt_collector(spec: ProblemSpec):
    """Collect modules' compact tilt rows, or None if any module only has
    the dense form (all-or-nothing: the KKT system must see every row)."""
    from membrane_solver_tpu.constraints import get_constraint

    builders = []
    for name in dict.fromkeys(spec.constraint_modules):
        mod = get_constraint(name)
        dense_maker = getattr(mod, "make_tilt_constraint_rows", None)
        if dense_maker is None:
            continue
        compact_maker = getattr(mod, "make_compact_tilt_rows", None)
        fn = compact_maker(spec) if compact_maker is not None else None
        if fn is None:
            return None  # this module's rows are not compact-representable
        builders.append(fn)
    if not builders:
        return None

    def collect(state, topo, params):
        raw = [b for b in (fn(state, topo, params) for fn in builders) if b is not None]
        if not raw:
            return None
        # normalize: modules return (vals, rows, leaf) or, with a rank-1
        # background component, (vals, rows, leaf, bg_coeff, bg_field)
        blocks = []
        for b in raw:
            if len(b) == 3:
                blocks.append((b[0], b[1], b[2], None, None))
            else:
                blocks.append(tuple(b))
        s_max = max(b[0].shape[1] for b in blocks)
        vs, rs, ls = [], [], []
        bgs = []
        offset = 0
        k_total = sum(b[0].shape[0] for b in blocks)
        for v, r, lf, bgc, bgf in blocks:
            if v.shape[1] < s_max:
                pad = s_max - v.shape[1]
                v = jnp.pad(v, ((0, 0), (0, pad), (0, 0)))
                r = jnp.pad(r, ((0, 0), (0, pad)))
                lf = jnp.pad(lf, ((0, 0), (0, pad)))
            if bgc is not None:
                c_full = (
                    jnp.zeros((k_total,), v.dtype)
                    .at[offset : offset + v.shape[0]]
                    .set(bgc)
                )
                bgs.append((c_full, bgf))
            offset += v.shape[0]
            vs.append(v)
            rs.append(r)
            ls.append(lf)
        return (
            jnp.concatenate(vs, axis=0),
            jnp.concatenate(rs, axis=0),
            jnp.concatenate(ls, axis=0),
            tuple(bgs),
        )

    return collect


def make_compact_tilt_projector(compact):
    """KKT projector over (in, out) tilt DOFs from compact slot rows.

    compact: (values (k, s, 3), rows (k, s), leaflet (k, s) 0=in/1=out,
    backgrounds).  Each row is the slot scatter plus, optionally, a rank-1
    background ``bg_coeff[i] * bg_field`` shared across rows (the
    mean-field disk coupling of rim matching).  The normal-equation matrix
    is assembled from slots — rows interact only where a slot vertex AND
    leaflet agree — plus the low-rank background cross terms, factored once
    per relax call; each iteration pays O(k s + Nv) gathers/scatters
    instead of O(k Nv) dense matvecs.  Identical projection to the dense
    form (up to summation order).
    """
    if compact is None:
        return lambda gin, gout: (gin, gout)
    vals, rows, leaf, *rest = compact
    bgs = rest[0] if rest else ()
    k = vals.shape[0]
    s = vals.shape[1]
    eq = (
        (rows[:, None, :, None] == rows[None, :, None, :])
        & (leaf[:, None, :, None] == leaf[None, :, None, :])
    ).astype(vals.dtype)
    dots = jnp.einsum("iac,jbc->ijab", vals, vals)
    A = jnp.sum(dots * eq, axis=(2, 3))
    for c, f in bgs:
        fb = f[leaf, rows]  # (k, s, 3) background gathered at the slots
        s_vec = jnp.einsum("iac,iac->i", vals, fb)
        A = A + c[:, None] * s_vec[None, :] + s_vec[:, None] * c[None, :]
    for c1, f1 in bgs:
        for c2, f2 in bgs:
            A = A + jnp.sum(f1 * f2) * (c1[:, None] * c2[None, :])
    A = A + 1e-18 * jnp.eye(k, dtype=vals.dtype)
    solver = dlinalg.make_dense_solver(A)

    def project(gin, gout):
        g2 = jnp.stack([gin, gout])  # (2, Nv, 3)
        b = jnp.einsum("iac,iac->i", vals, g2[leaf, rows])
        for c, f in bgs:
            b = b + c * jnp.sum(f * g2)
        lam = solver(b)
        corr = jnp.zeros_like(g2).at[leaf, rows].add(lam[:, None, None] * vals)
        for c, f in bgs:
            corr = corr + jnp.dot(lam, c) * f
        return gin - corr[0], gout - corr[1]

    return project


def jacobi_preconditioner(positions, topo, params):
    """(M_inv_in, M_inv_out) per runtime/preconditioners.py:64-146."""
    from membrane_solver_tpu.energy.leaflet_presence import present_triangles

    dtype = positions.dtype
    n_rows = positions.shape[0]
    geo = dgeo.triangle_geometry(positions, topo.tri_rows, topo.tri_valid)
    vertex_areas = dgeo.barycentric_vertex_areas(geo, topo.tri_rows, n_rows)
    # the relax manager feeds the preconditioner the leaflet-present areas
    # for the OUT leaflet (tilt_relaxation.py:675-697 -> preconditioners.py
    # tilt_vertex_areas_out), so out-rows on absent patches lose their mass
    # term; the smoothness row sums stay unmasked on both leaflets
    present_out = present_triangles(topo, "out")
    if present_out is not None:
        geo_masked_area = jnp.where(present_out, geo.area, 0.0)
        a3 = geo_masked_area / 3.0
        vertex_areas_out = dgeo.scatter_add_rows(a3, a3, a3, topo.tri_rows, n_rows)
    else:
        vertex_areas_out = vertex_areas
    curv = dgeo.curvature_data(positions, topo.tri_rows, topo.tri_valid, n_rows)
    c0, c1, c2 = curv.weights[:, 0], curv.weights[:, 1], curv.weights[:, 2]

    def diag_for(k_tilt, k_smooth, fixed_mask, areas):
        diag = k_tilt * areas
        rowsum = dgeo.scatter_add_rows(
            0.5 * k_smooth * (c1 + c2),
            0.5 * k_smooth * (c2 + c0),
            0.5 * k_smooth * (c0 + c1),
            topo.tri_rows,
            n_rows,
        )
        diag = diag + rowsum
        diag = jnp.where(diag > 1e-12, diag, 1.0)
        diag = jnp.where(fixed_mask, 1.0, diag)
        return 1.0 / diag

    zero = jnp.asarray(0.0, dtype)
    k_in = params.get("tilt_modulus_in", zero)
    k_out = params.get("tilt_modulus_out", zero)
    kb = params.get("bending_modulus", zero)
    kb_in = params.get("bending_modulus_in", kb)
    kb_out = params.get("bending_modulus_out", kb)
    return (
        diag_for(k_in, kb_in, topo.tilt_fixed_in_mask, vertex_areas),
        diag_for(k_out, kb_out, topo.tilt_fixed_out_mask, vertex_areas_out),
    )


def collect_frozen_tilt_program(spec: ProblemSpec):
    """Frozen-geometry inner-solve program, or None if unsupported.

    Positions are constant for the whole inner tilt solve, so every
    position-only field (triangle areas, curvature data, P1 gradients, ring
    directions, matching payloads) can be computed ONCE per relax call and
    the per-iteration graph shrinks to the tilt-dependent part — identical
    arithmetic, so values/gradients match the full path exactly.  Modules
    opt in via ``make_tilt_frozen`` (energies) / ``make_frozen_enforce_tilts``
    (constraints); if any active tilt module or tilt enforcer lacks the hook,
    the relax falls back to the full per-iteration evaluation.
    """
    import os

    if os.environ.get("MEMBRANE_SOLVER_FROZEN_TILT", "1") in {"0", "false", "no"}:
        return None

    from membrane_solver_tpu.constraints import get_constraint
    from membrane_solver_tpu.runtime.jit_core import active_energy_modules

    e_pre, e_fns, e_names = [], [], []
    for name in active_energy_modules(spec):
        module = get_module(name)
        if not (
            getattr(module, "USES_TILT", False)
            or getattr(module, "USES_TILT_LEAFLETS", False)
        ):
            continue
        hook = getattr(module, "make_tilt_frozen", None)
        if hook is None:
            return None
        pre, fn = hook(spec)
        from membrane_solver_tpu.runtime.jit_core import module_scale_fn

        sc = module_scale_fn(spec, name)
        if sc is not None:
            def fn(tin, tout, fr, topo, params, ctx=None, _fn=fn, _sc=sc):
                return _sc(params, tin.dtype) * _fn(tin, tout, fr, topo, params, ctx)

        e_pre.append(pre)
        e_fns.append(fn)
        e_names.append(name)

    c_pre, c_fns = [], []
    for name in dict.fromkeys(spec.constraint_modules):
        mod = get_constraint(name)
        maker = getattr(mod, "make_enforce_tilts", None)
        full = maker(spec) if maker is not None else getattr(mod, "enforce_tilts", None)
        if full is None:
            continue  # module contributes no tilt enforcement
        fhook = getattr(mod, "make_frozen_enforce_tilts", None)
        if fhook is None:
            return None
        out = fhook(spec)
        if out is None:
            continue
        pre, fn = out
        c_pre.append(pre)
        c_fns.append(fn)
    return e_pre, e_fns, c_pre, c_fns, e_names


def make_frozen_energy_pair(frozen_prog, state, topo, params):
    """energy_pair(t_in, t_out) of the frozen-geometry tilt program.

    The position-only fields are computed here, once; the returned function
    is the tilt-dependent part, summed module by module.
    """
    e_pre, e_fns, _c_pre, _c_fns, _e_names = frozen_prog
    dtype = state.positions.dtype
    e_frozen = [p(state, topo, params) for p in e_pre]

    def energy_pair(t_in, t_out):
        # shared corner bundle: ONE (F, 3, 3) gather per leaflet field feeds
        # every module (and AD transposes it into ONE scatter per field),
        # instead of 3 gathers + 3 scatters per module
        ctx = {"tin_c": t_in[topo.tri_rows], "tout_c": t_out[topo.tri_rows]}
        e = jnp.asarray(0.0, dtype)
        for fn, f in zip(e_fns, e_frozen):
            e = e + fn(t_in, t_out, f, topo, params, ctx)
        return e

    return energy_pair


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TiltRelaxStats:
    accepted_steps: jnp.ndarray
    rejected: jnp.ndarray  # bool: ended on line-search rejection
    initial_energy: jnp.ndarray
    final_energy: jnp.ndarray
    final_gradient_norm: jnp.ndarray


_MAKER_CACHE: dict = {}


def _memo_by_spec(maker):
    """Memoize a make_*(spec) factory by spec, and jit its product.

    The direct host entry points (theta_B candidate scans, the
    Minimizer.relax_leaflet_tilts surface, telemetry probes) used to
    rebuild the whole relax closure per call, re-tracing the inner CG
    while_loop every time — ~2 s/step of pure tracing on the
    profile_relax_light lane.  One traced program per (spec, factory) now
    serves every later call.
    """
    import functools

    @functools.wraps(maker)
    def wrapped(spec):
        key = (maker.__name__, spec)
        if key not in _MAKER_CACHE:
            _MAKER_CACHE[key] = jax.jit(maker(spec))
        return _MAKER_CACHE[key]

    return wrapped


@_memo_by_spec
def make_relax_leaflet_tilts(spec: ProblemSpec) -> Callable:
    """relax(state, topo, params) -> (state, TiltRelaxStats), fully traced."""
    tilt_energy = make_tilt_energy(spec)
    constraint_rows_fn = make_tilt_constraint_rows(spec)
    compact_collector = make_compact_tilt_collector(spec)
    tilt_enforce = make_tilt_enforcer(spec)
    solver = spec.option("tilt_solver", "cg").lower()
    use_precond = (
        solver == "cg"
        and spec.option("tilt_cg_preconditioner", "jacobi").lower()
        not in {"none", "off", "false"}
    )
    # per-accepted-step vs end-of-pass constraint-refresh cadence
    # (reference tilt_relaxation.py:494-505, 1049-1051, 1412-1413)
    projection_cadence = spec.option("tilt_projection_cadence", "per_step").lower()
    if projection_cadence not in {"per_step", "per_pass"}:
        raise ValueError("tilt_projection_cadence must be 'per_step' or 'per_pass'.")

    def energy_of(tin, tout, state, topo, params):
        st = dataclasses.replace(state, tilts_in=tin, tilts_out=tout)
        return tilt_energy(st, topo, params)

    # jit: the tilt-energy graph traces once and is shared by every call
    # site in the inner loop (grad eval + backtracking trials)
    energy_of = jax.jit(energy_of)
    grad_fn = jax.jit(jax.value_and_grad(energy_of, argnums=(0, 1)))
    frozen_prog = collect_frozen_tilt_program(spec)

    def relax(state: MeshState, topo: Topology, params: Dict, max_iters, step_size, tol):
        dtype = state.positions.dtype
        positions = state.positions
        n_rows = positions.shape[0]
        geo = dgeo.triangle_geometry(positions, topo.tri_rows, topo.tri_valid)
        normals = dgeo.vertex_normals(geo, topo.tri_rows, topo.tri_valid, n_rows)
        fixed_in = topo.tilt_fixed_in_mask
        fixed_out = topo.tilt_fixed_out_mask

        def tangent_plain(t):
            return t - jnp.sum(t * normals, axis=1, keepdims=True) * normals

        if spec.option("tilt_axisym", "off") == "on":
            # axisymmetric radial-subspace projection about the theta_B axis
            # (reference projections/tilt.py:16-97), composed after the
            # tangent projection; fixed rows keep their values
            center = topo.extras["core:tilt_axisym/center"].astype(dtype)
            axis = topo.extras["core:tilt_axisym/axis"].astype(dtype)
            r_vec = positions - center
            r_vec = r_vec - jnp.sum(r_vec * axis, axis=1, keepdims=True) * axis
            r_len = jnp.linalg.norm(r_vec, axis=1)
            good0 = r_len > 1e-12
            r_hat = jnp.where(good0[:, None], r_vec / jnp.maximum(r_len, 1e-12)[:, None], 0.0)
            r_dir = r_hat - jnp.sum(r_hat * normals, axis=1, keepdims=True) * normals
            r_norm = jnp.linalg.norm(r_dir, axis=1)
            good = good0 & (r_norm > 1e-12)
            r_unit = jnp.where(good[:, None], r_dir / jnp.maximum(r_norm, 1e-12)[:, None], 0.0)

            def axisym(t, fixed_mask):
                t_tan = tangent_plain(t)
                amp = jnp.sum(t_tan * r_unit, axis=1)
                proj = jnp.where(good[:, None], amp[:, None] * r_unit, 0.0)
                return jnp.where(fixed_mask[:, None], t_tan, proj)

            def tangent_in(t):
                return axisym(t, fixed_in)

            def tangent_out(t):
                return axisym(t, fixed_out)
        else:
            tangent_in = tangent_out = tangent_plain

        # frozen-geometry program: position-only fields computed once per
        # relax call; the per-iteration graph is only the tilt-dependent part
        if frozen_prog is not None:
            c_pre, c_fns = frozen_prog[2:4]
            c_frozen = [p(state, topo, params) for p in c_pre]
            energy_pair = make_frozen_energy_pair(frozen_prog, state, topo, params)
            vg_pair = jax.value_and_grad(energy_pair, argnums=(0, 1))

            def enforce_pair(t_in, t_out):
                for fn, f in zip(c_fns, c_frozen):
                    t_in, t_out = fn(t_in, t_out, f, topo, params)
                return t_in, t_out

        else:

            def energy_pair(t_in, t_out):
                return energy_of(t_in, t_out, state, topo, params)

            def vg_pair(t_in, t_out):
                return grad_fn(t_in, t_out, state, topo, params)

            def enforce_pair(t_in, t_out):
                st = tilt_enforce(
                    dataclasses.replace(state, tilts_in=t_in, tilts_out=t_out),
                    topo,
                    params,
                )
                return st.tilts_in, st.tilts_out

        # 1. enforce tilt constraints + tangent-project (+ optional axisym)
        tin, tout = enforce_pair(state.tilts_in, state.tilts_out)
        tin = tangent_in(tin)
        tout = tangent_out(tout)
        fixed_vals_in = tin
        fixed_vals_out = tout

        # constraint rows depend on positions only (frozen here): build them
        # and factor the KKT normal equations once for the whole inner solve.
        # NOTE the gp key tilt_kkt_projection_during_relaxation is accepted
        # but ignored, as in the reference: its runtime never reads it (the
        # flat-disk tools set it, but the projection always applies).
        if compact_collector is not None:
            projector = make_compact_tilt_projector(
                compact_collector(state, topo, params)
            )
        else:
            rows = constraint_rows_fn(state, topo, params)
            projector = make_tilt_projector(rows)

        def eval_grads(tin, tout, st):
            E, (gin, gout) = vg_pair(tin, tout)
            gin, gout = projector(gin, gout)
            gin = jnp.where(fixed_in[:, None], 0.0, gin)
            gout = jnp.where(fixed_out[:, None], 0.0, gout)
            gnorm = jnp.sqrt(jnp.sum(gin * gin) + jnp.sum(gout * gout))
            return E, gin, gout, gnorm

        if use_precond:
            m_in, m_out = jacobi_preconditioner(positions, topo, params)
        else:
            m_in = jnp.ones(n_rows, dtype)
            m_out = jnp.ones(n_rows, dtype)

        apply_delta_cap = None
        if (
            spec.option("inner_coupled_update_mode", "off").strip().lower()
            == "rim_matched_radial_continuation_v1"
            and "core:inner_coupled/center_xy" in topo.extras
        ):
            apply_delta_cap = make_inner_coupled_delta_cap(
                positions, topo, params, fixed_in
            )


        def build_trial(base_in, base_out, delta_in, delta_out):
            if apply_delta_cap is not None:
                delta_in = apply_delta_cap(delta_in)
            trial_in = tangent_in(base_in + delta_in)
            trial_out = tangent_out(base_out + delta_out)
            trial_in = jnp.where(fixed_in[:, None], fixed_vals_in, trial_in)
            trial_out = jnp.where(fixed_out[:, None], fixed_vals_out, trial_out)
            return trial_in, trial_out

        def backtrack(tin, tout, dir_in, dir_out, E0):
            """12-halving backtracking accept-if-not-worse (tilt_relaxation.py:930-975)."""

            def body(carry):
                step, bt, done, acc_in, acc_out, acc_E, accepted = carry
                trial_in, trial_out = build_trial(tin, tout, step * dir_in, step * dir_out)
                E1 = energy_pair(trial_in, trial_out)
                accept = E1 <= E0
                new_step = jnp.where(accept, step, step * 0.5)
                new_done = accept | (new_step < STEP_FLOOR) | (bt + 1 >= MAX_BACKTRACKS)
                return (
                    new_step,
                    bt + 1,
                    new_done,
                    jnp.where(accept, trial_in, acc_in),
                    jnp.where(accept, trial_out, acc_out),
                    jnp.where(accept, E1, acc_E),
                    accepted | accept,
                )

            def cond(carry):
                _step, _bt, done, *_ = carry
                return ~done

            init = (
                step_size,
                jnp.asarray(0, jnp.int32),
                jnp.asarray(False),
                tin,
                tout,
                E0,
                jnp.asarray(False),
            )
            _step, _bt, _done, acc_in, acc_out, acc_E, accepted = jax.lax.while_loop(
                cond, body, init
            )
            return accepted, acc_in, acc_out, acc_E

        # cadence: enforce+re-project after an accepted step only when
        # (post-increment accepted count % interval) == 0 and cadence is
        # per_step; per_pass defers to a single refresh after the loop.
        # Trials are already tangent-projected and fixed-clamped by
        # build_trial, so a skipped refresh carries the raw accepted tilts
        # forward, exactly as the reference does.
        proj_interval = jnp.maximum(
            jnp.asarray(params.get("tilt_projection_interval", 1.0), jnp.int32), 1
        )

        def refresh_pair(t_in, t_out):
            e_in, e_out = enforce_pair(t_in, t_out)
            return tangent_in(e_in), tangent_out(e_out)

        if solver == "gd":

            def body(carry):
                tin, tout, i, done, nacc, rejected, E_last, g_last = carry
                E0, gin, gout, gnorm = eval_grads(tin, tout, state)
                conv = (gnorm == 0.0) | ((tol > 0.0) & (gnorm < tol))
                accepted, new_in, new_out, E1 = backtrack(tin, tout, -gin, -gout, E0)
                take = accepted & ~conv
                nacc_new = nacc + take.astype(jnp.int32)
                if projection_cadence == "per_step":
                    do_proj = take & ((nacc_new % proj_interval) == 0)
                else:
                    do_proj = jnp.asarray(False)
                prj_in, prj_out = refresh_pair(new_in, new_out)
                return (
                    jnp.where(do_proj, prj_in, jnp.where(take, new_in, tin)),
                    jnp.where(do_proj, prj_out, jnp.where(take, new_out, tout)),
                    i + 1,
                    done | conv | ~accepted,
                    nacc_new,
                    rejected | (~accepted & ~conv),
                    jnp.where(conv, E0, E1),
                    gnorm,
                )

            def cond(carry):
                _ti, _to, i, done, *_ = carry
                return (~done) & (i < max_iters)

            init = (
                tin,
                tout,
                jnp.asarray(0, jnp.int32),
                jnp.asarray(False),
                jnp.asarray(0, jnp.int32),
                jnp.asarray(False),
                jnp.asarray(0.0, dtype),
                jnp.asarray(0.0, dtype),
            )
            (tin, tout, _i, _done, nacc, rejected, E_last, g_last) = jax.lax.while_loop(
                cond, body, init
            )
            E_first = jnp.asarray(0.0, dtype)
        else:
            # CG path (tilt_relaxation.py:1056-1410)
            cg_fallback_gd = (
                spec.option("tilt_cg_rejection_fallback", "off").lower() == "gd"
            )
            E0, gin, gout, gnorm = eval_grads(tin, tout, state)
            E_first = E0
            r_in, r_out = -gin, -gout
            z_in = r_in * m_in[:, None]
            z_out = r_out * m_out[:, None]
            d_in, d_out = z_in, z_out
            rz_old = jnp.sum(r_in * z_in) + jnp.sum(r_out * z_out)

            # f32 monotone net (static: dtype known at trace time).  The
            # f32 throughput mode is THIS framework's extension — the
            # reference is f64-only — so near the f32 noise floor the CG's
            # accept-if-not-worse tests (resolution ~|E|*6e-8 per eval) stop
            # discriminating and the beta-momentum can random-walk the relax
            # UPHILL (observed +2.08 energy in one 40-iteration relax on the
            # kozlov lane, round-5 f32-parity investigation).  Track the
            # best post-refresh state seen and return it if the final state
            # is worse; in f64 the tracking is skipped entirely so every
            # recorded 1e-12 parity fixture is untouched.
            # MEMBRANE_SOLVER_TILT_MONOTONE=0 is a debugging escape hatch to
            # reproduce the raw (reference-semantics) f32 behavior.
            import os as _os

            monotone = (jnp.dtype(dtype) != jnp.float64) and _os.environ.get(
                "MEMBRANE_SOLVER_TILT_MONOTONE", "1"
            ) != "0"

            def body(carry):
                (tin, tout, d_in, d_out, gin, gout, rz_old, E0, gnorm, i, done, nacc, rejected,
                 best_in, best_out, best_E) = carry
                conv = (gnorm == 0.0) | ((tol > 0.0) & (gnorm < tol))
                accepted, new_in, new_out, E1 = backtrack(tin, tout, d_in, d_out, E0)
                if cg_fallback_gd:
                    # on CG-direction rejection, retry the backtracking with
                    # raw steepest descent from the full step size before
                    # giving up (reference tilt_relaxation.py:1203-1263)
                    def gd_retry(_):
                        return backtrack(tin, tout, -gin, -gout, E0)

                    def keep(_):
                        return accepted, new_in, new_out, E1

                    accepted, new_in, new_out, E1 = jax.lax.cond(
                        accepted, keep, gd_retry, None
                    )
                take = accepted & ~conv
                nacc_new = nacc + take.astype(jnp.int32)
                # per-accepted-step constraint refresh + tangent projection
                # (subject to the projection cadence)
                if projection_cadence == "per_step":
                    do_proj = take & ((nacc_new % proj_interval) == 0)
                else:
                    do_proj = jnp.asarray(False)
                prj_in, prj_out = refresh_pair(new_in, new_out)
                new_in2 = jnp.where(do_proj, prj_in, jnp.where(take, new_in, tin))
                new_out2 = jnp.where(do_proj, prj_out, jnp.where(take, new_out, tout))
                E2, gin2, gout2, gnorm2 = eval_grads(new_in2, new_out2, state)
                r_in, r_out = -gin2, -gout2
                z_in = r_in * m_in[:, None]
                z_out = r_out * m_out[:, None]
                rz_new = jnp.sum(r_in * z_in) + jnp.sum(r_out * z_out)
                beta = jnp.where(rz_old != 0.0, rz_new / rz_old, 0.0)
                nd_in = z_in + beta * d_in
                nd_out = z_out + beta * d_out
                stop = conv | ~accepted | (rz_old == 0.0)
                upd = take & (E2 < best_E)
                return (
                    new_in2,
                    new_out2,
                    jnp.where(stop, d_in, nd_in),
                    jnp.where(stop, d_out, nd_out),
                    jnp.where(take, gin2, gin),
                    jnp.where(take, gout2, gout),
                    jnp.where(stop, rz_old, rz_new),
                    jnp.where(take, E2, E0),
                    jnp.where(take, gnorm2, gnorm),
                    i + 1,
                    done | stop,
                    nacc_new,
                    rejected | (~accepted & ~conv),
                    jnp.where(upd, new_in2, best_in),
                    jnp.where(upd, new_out2, best_out),
                    jnp.where(upd, E2, best_E),
                )

            def cond(carry):
                (*_rest, i, done, _nacc, _rej, _bi, _bo, _bE) = carry
                return (~done) & (i < max_iters)

            init = (
                tin,
                tout,
                d_in,
                d_out,
                gin,
                gout,
                rz_old,
                E0,
                gnorm,
                jnp.asarray(0, jnp.int32),
                jnp.asarray(False),
                jnp.asarray(0, jnp.int32),
                jnp.asarray(False),
                tin,
                tout,
                E0,
            )
            (tin, tout, _di, _do, _gi, _go, _rz, E_last, g_last, _i, _done, nacc, rejected,
             best_in, best_out, best_E) = (
                jax.lax.while_loop(cond, body, init)
            )
            if monotone:
                # revert to the best accepted state when the CG walked uphill
                use_best = best_E < E_last
                tin = jnp.where(use_best, best_in, tin)
                tout = jnp.where(use_best, best_out, tout)
                E_last = jnp.where(use_best, best_E, E_last)

        if projection_cadence == "per_pass":
            # one refresh for the whole pass (reference :1412-1413),
            # applied unconditionally like the reference's
            tin, tout = refresh_pair(tin, tout)

        out_state = dataclasses.replace(state, tilts_in=tin, tilts_out=tout)
        stats = TiltRelaxStats(
            accepted_steps=nacc,
            rejected=rejected,
            initial_energy=E_first,
            final_energy=E_last,
            final_gradient_norm=g_last,
        )
        return out_state, stats

    return relax


@_memo_by_spec
def make_relax_vertex_tilts(spec: ProblemSpec) -> Callable:
    """Single-field tilt relaxation (the reference's _relax_tilts path).

    Parity: runtime/steppers/tilt_relaxation.py:237-424 — GD or Jacobi-
    preconditioned CG on the mesh's single ``tilts`` field with positions
    frozen: tangent projection per trial, fixed-row clamping, 12-halving
    accept-if-not-worse backtracking, convergence on the projected gradient
    norm.  None of the single-field constraint modules contribute tilt
    constraint rows in the reference's registry, so no KKT projection runs
    here (the leaflet path handles the rim-matching lanes).
    """
    tilt_energy = make_tilt_energy(spec)
    solver = spec.option("tilt_solver", "cg").lower()
    use_precond = (
        solver == "cg"
        and spec.option("tilt_cg_preconditioner", "jacobi").lower()
        not in {"none", "off", "false"}
    )

    def energy_of(tilts, state, topo, params):
        return tilt_energy(dataclasses.replace(state, tilts=tilts), topo, params)

    energy_of = jax.jit(energy_of)
    grad_fn = jax.jit(jax.value_and_grad(energy_of))

    def relax(state: MeshState, topo: Topology, params: Dict, max_iters, step_size, tol):
        dtype = state.positions.dtype
        positions = state.positions
        n_rows = positions.shape[0]
        geo = dgeo.triangle_geometry(positions, topo.tri_rows, topo.tri_valid)
        normals = dgeo.vertex_normals(geo, topo.tri_rows, topo.tri_valid, n_rows)
        fixed = topo.tilt_fixed_mask

        def tangent(t):
            return t - jnp.sum(t * normals, axis=1, keepdims=True) * normals

        tilts = tangent(state.tilts)
        fixed_vals = tilts

        if use_precond:
            m_in, _m_out = jacobi_preconditioner(positions, topo, params)
        else:
            m_in = jnp.ones(n_rows, dtype)

        def eval_grads(t):
            E, g = grad_fn(t, state, topo, params)
            g = jnp.where(fixed[:, None], 0.0, g)
            return E, g, jnp.linalg.norm(g)

        def build_trial(base, delta):
            trial = tangent(base + delta)
            return jnp.where(fixed[:, None], fixed_vals, trial)

        def backtrack(t, direction, E0):
            def body(carry):
                step, bt, done, acc, acc_E, accepted = carry
                trial = build_trial(t, step * direction)
                E1 = energy_of(trial, state, topo, params)
                accept = E1 <= E0
                new_step = jnp.where(accept, step, step * 0.5)
                new_done = accept | (new_step < STEP_FLOOR) | (bt + 1 >= MAX_BACKTRACKS)
                return (
                    new_step,
                    bt + 1,
                    new_done,
                    jnp.where(accept, trial, acc),
                    jnp.where(accept, E1, acc_E),
                    accepted | accept,
                )

            def cond(carry):
                _s, _b, done, *_ = carry
                return ~done

            init = (step_size, jnp.asarray(0, jnp.int32), jnp.asarray(False), t, E0, jnp.asarray(False))
            _s, _b, _d, acc, acc_E, accepted = jax.lax.while_loop(cond, body, init)
            return accepted, acc, acc_E

        if solver == "gd":
            def body(carry):
                t, i, done, nacc = carry
                E0, g, gnorm = eval_grads(t)
                conv = (gnorm == 0.0) | ((tol > 0.0) & (gnorm < tol))
                accepted, new_t, _E1 = backtrack(t, -g, E0)
                take = accepted & ~conv
                return (
                    jnp.where(take, new_t, t),
                    i + 1,
                    done | conv | ~accepted,
                    nacc + take.astype(jnp.int32),
                )

            def cond(carry):
                _t, i, done, _n = carry
                return (~done) & (i < max_iters)

            t, _i, _d, nacc = jax.lax.while_loop(
                cond, body, (tilts, jnp.asarray(0, jnp.int32), jnp.asarray(False), jnp.asarray(0, jnp.int32))
            )
        else:
            E0, g, gnorm = eval_grads(tilts)
            r = -g
            z = r * m_in[:, None]
            d = z
            rz_old = jnp.sum(r * z)

            def body(carry):
                t, d, rz_old, E0, gnorm, i, done, nacc = carry
                conv = (gnorm == 0.0) | ((tol > 0.0) & (gnorm < tol))
                accepted, new_t, _E1 = backtrack(t, d, E0)
                take = accepted & ~conv
                new_t = jnp.where(take, new_t, t)
                E2, g, gnorm2 = eval_grads(new_t)
                r = -g
                z = r * m_in[:, None]
                rz_new = jnp.sum(r * z)
                beta = jnp.where(rz_old != 0.0, rz_new / rz_old, 0.0)
                nd = z + beta * d
                stop = conv | ~accepted | (rz_old == 0.0)
                return (
                    new_t,
                    jnp.where(stop, d, nd),
                    jnp.where(stop, rz_old, rz_new),
                    jnp.where(take, E2, E0),
                    jnp.where(take, gnorm2, gnorm),
                    i + 1,
                    done | stop,
                    nacc + take.astype(jnp.int32),
                )

            def cond(carry):
                (*_r, i, done, _n) = carry
                return (~done) & (i < max_iters)

            t, _d, _rz, _E, _gn, _i, _done, nacc = jax.lax.while_loop(
                cond,
                body,
                (tilts, d, rz_old, E0, gnorm, jnp.asarray(0, jnp.int32), jnp.asarray(False), jnp.asarray(0, jnp.int32)),
            )

        return dataclasses.replace(state, tilts=t), nacc

    return relax
