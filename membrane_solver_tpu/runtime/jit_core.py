"""Jitted minimization core: energy assembly, Armijo line search, steppers.

This is the JAX rebuild of the reference's hot path:

- energy/gradient assembly      (runtime/evaluation_manager.py:20-743,
                                 runtime/minimizer.py:940-991)
- Armijo backtracking line search with max-displacement/normal-flip safety
                                (runtime/steppers/line_search.py:261-529)
- gradient-descent / conjugate-gradient / BFGS steppers
                                (runtime/steppers/{gradient_descent,
                                 conjugate_gradient,bfgs}.py)
- the outer minimize iteration  (runtime/minimizer.py:1176-1531)

Everything below runs under one `jax.jit` per (ProblemSpec, options) pair as a
fixed-shape `lax.while_loop`; topology changes that keep capacities constant
re-use the compiled executable.  Gradients come from `jax.value_and_grad`
through the energy assembly (equivalent to the reference's analytic gradients,
which are themselves hand-written backprop).
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import Callable, Dict, Tuple

import jax
import jax.numpy as jnp

from membrane_solver_tpu.device import geo as dgeo
from membrane_solver_tpu.device import linalg as dlinalg
from membrane_solver_tpu.device.state import MeshState, ProblemSpec, Topology
from membrane_solver_tpu.energy import get_module

# Armijo line-search constants (reference line_search.py defaults)
LS_MAX_ITER = 10
LS_BETA = 0.7
LS_C = 1e-4
LS_GAMMA = 1.5
LS_ALPHA_MAX_FACTOR = 10.0
LS_ALPHA_FLOOR = 1e-8
SAFE_STEP_FRACTION = 0.3
NORMAL_LIMIT_RADIANS = 0.5


# ----------------------------------------------------------------------
# energy assembly
# ----------------------------------------------------------------------
def active_energy_modules(spec: ProblemSpec) -> Tuple[str, ...]:
    """Module names that can contribute under the current mode switches."""
    names = []
    for name in spec.energy_modules:
        if name == "volume" and spec.volume_mode != "penalty":
            continue  # soft penalty inactive in lagrange mode (volume.py:21-23)
        names.append(name)
    return tuple(names)


def module_scale_fn(spec: ProblemSpec, name: str):
    """Per-module experimental scale for the curved-theta ablation, or None.

    Parity: reference minimizer._experimental_energy_scale_for_module
    (minimizer.py:501-566) — active only when
    curved_theta_objective_ablation_mode=inner_outer_rescaled AND
    benchmark_geometry_lane=free_z AND benchmark_parameterization=
    kh_physical; inner/outer/contact module families scale by the three
    ablation factors (traced params, validated > 0 by the reference).
    """
    mode = spec.option("curved_theta_objective_ablation_mode", "off").lower()
    if mode == "off":
        return None
    if mode != "inner_outer_rescaled":
        raise ValueError(
            "curved_theta_objective_ablation_mode must be 'off' or "
            "'inner_outer_rescaled'."
        )
    if spec.option("benchmark_geometry_lane", "flat_pinned").lower() != "free_z":
        return None
    if spec.option("benchmark_parameterization", "legacy").lower() != "kh_physical":
        return None
    if name in {"tilt_in", "bending_tilt_in", "tilt_splay_twist_in", "tilt_smoothness_in"}:
        key = "curved_theta_objective_ablation_inner_scale"
    elif name in {
        "tilt_out",
        "bending_tilt_out",
        "tilt_smoothness_out",
        "tilt_rim_source_out",
        "tilt_disk_target_out",
    }:
        key = "curved_theta_objective_ablation_outer_scale"
    elif name == "tilt_thetaB_contact_in":
        key = "curved_theta_objective_ablation_contact_scale"
    else:
        return None

    def scale(params, dtype):
        return params.get(key, jnp.asarray(1.0, dtype))

    return scale


def make_total_energy(spec: ProblemSpec) -> Callable:
    """Return total_energy(state, topo, params) -> scalar."""
    fns = []
    for name in active_energy_modules(spec):
        module = get_module(name)
        maker = getattr(module, "make_energy", None)
        fns.append((maker(spec) if maker is not None else module.energy,
                    module_scale_fn(spec, name)))

    def total_energy(state: MeshState, topo: Topology, params: Dict) -> jnp.ndarray:
        geo = dgeo.triangle_geometry(state.positions, topo.tri_rows, topo.tri_valid)
        dtype = state.positions.dtype
        e = jnp.asarray(0.0, dtype=dtype)
        for fn, sc in fns:
            term = fn(geo, state, topo, params)
            if sc is not None:
                term = sc(params, dtype) * term
            e = e + term
        return e

    # jit so the (large) energy graph is traced once per abstract signature
    # and re-used at every call site inside the minimize block — the block
    # invokes it ~10x (value+grad, line-search trials, tilt guard) and
    # re-tracing it each time dominated warm-start latency.
    return jax.jit(total_energy)


def make_energy_of_positions(spec: ProblemSpec) -> Callable:
    """Return energy_fn(positions, state, topo, params) with tilts held fixed."""
    total = make_total_energy(spec)

    def energy_fn(positions, state, topo, params):
        return total(dataclasses.replace(state, positions=positions), topo, params)

    return energy_fn


def make_energy_vg(spec: ProblemSpec) -> Callable:
    """Cached jitted value_and_grad of the positions energy.

    vg(positions, state, topo, params) -> (E, dE/dpositions); explicit args
    (no closures) so the traced jaxpr is shared across every call site in
    the minimize block.
    """
    key = (spec, "__energy_vg__")
    if key not in _BLOCK_CACHE:
        _BLOCK_CACHE[key] = jax.jit(
            jax.value_and_grad(make_energy_of_positions(spec))
        )
    return _BLOCK_CACHE[key]


# ----------------------------------------------------------------------
# constraint KKT projection of the shape gradient
# ----------------------------------------------------------------------
def make_constraint_gradients(spec: ProblemSpec) -> Callable:
    """Return fn(state, topo, params) -> (k, Nv, 3) stacked constraint gradients.

    Parity: constraint modules' ``constraint_gradients_array`` collected by
    runtime/constraint_manager.py:apply_gradient_modifications_array.
    k is static (compile-time): one row per body with a volume target when the
    volume constraint is active, plus rows from other registered constraints.
    """
    from membrane_solver_tpu.constraints import get_constraint

    builders = []
    for name in dict.fromkeys(spec.constraint_modules):
        mod = get_constraint(name)
        maker = getattr(mod, "make_constraint_gradient_rows", None)
        fn = maker(spec) if maker is not None else getattr(mod, "constraint_gradient_rows", None)
        if fn is not None:
            builders.append(fn)

    if not builders:
        return lambda state, topo, params: None

    def all_gradients(state, topo, params):
        rows = []
        for fn in builders:
            out = fn(state, topo, params)
            if out is not None:
                rows.append(out)
        if not rows:
            return None
        return jnp.concatenate(rows, axis=0)

    return all_gradients


def project_gradient_kkt(grad: jnp.ndarray, constraint_grads) -> jnp.ndarray:
    """Project grad against the span of constraint gradients (KKT solve).

    Parity: runtime/constraint_manager.py:300-315 (1-constraint fast path) and
    runtime/constraint_projection.py KKT ``A lam = b`` with tiny dense A.
    """
    if constraint_grads is None:
        return grad
    k = constraint_grads.shape[0]
    flatg = grad.reshape(-1)
    G = constraint_grads.reshape(k, -1)
    if k == 1:
        gC = G[0]
        norm_sq = jnp.dot(gC, gC)
        lam = jnp.where(norm_sq > 1e-18, jnp.dot(flatg, gC) / jnp.maximum(norm_sq, 1e-18), 0.0)
        return (flatg - lam * gC).reshape(grad.shape)
    A = G @ G.T + 1e-18 * jnp.eye(k, dtype=grad.dtype)
    b = G @ flatg
    lam = _solve_kkt_with_rescue(A, b, k)
    return (flatg - lam @ G).reshape(grad.shape)


def _solve_kkt_with_rescue(A: jnp.ndarray, b: jnp.ndarray, k: int) -> jnp.ndarray:
    """Solve the (already 1e-18-regularized) KKT normal equations.

    Solving directly matches the reference's _solve_kkt_system: near-null
    constraint directions (duplicated/negated rows) still project with
    sigma^2/(sigma^2 + 1e-18) weighting — an SVD least-squares with an
    rcond cutoff would drop them and produce a different projection.

    Singular systems: EXACTLY duplicated/negated rows (e.g. the rim
    matching out/in shape-row pairs) make A_ii = x + 1e-18 round back to
    x, so A is singular in f64 and the solve yields non-finite
    multipliers.  The reference's _solve_kkt_system returns None there and
    the projection is SKIPPED for that step
    (runtime/constraint_projection.py:57-67, 126-128); mirror that exactly
    by zeroing the multipliers — a ridge re-solve would instead descend
    along a trajectory the reference never takes.
    """
    lam = dlinalg.solve_spd(A, b)
    return jnp.where(jnp.all(jnp.isfinite(lam)), lam, jnp.zeros_like(lam))


def orthonormalize_local_normals(normals: jnp.ndarray) -> jnp.ndarray:
    """Per-vertex modified Gram-Schmidt over the m stacked constraint normals.

    normals: (Nv, m, 3), zero rows allowed.  Returns (Nv, m, 3) orthonormal
    (or zero) directions spanning the same per-vertex constraint space.
    Near-parallel duplicates collapse to zero (the regularized dense solve
    weights them sigma^2/(sigma^2+1e-18) — both project onto the same span).
    """
    m = normals.shape[1]
    outs = []
    for j in range(m):
        v = normals[:, j]
        for q in outs:
            v = v - jnp.sum(v * q, axis=1, keepdims=True) * q
        nrm = jnp.linalg.norm(v, axis=1, keepdims=True)
        outs.append(jnp.where(nrm > 1e-12, v / jnp.maximum(nrm, 1e-12), 0.0))
    return jnp.stack(outs, axis=1)


def apply_local_projection(vec: jnp.ndarray, n_hat: jnp.ndarray) -> jnp.ndarray:
    """Project (Nv, 3) rows onto the orthogonal complement of each vertex's
    orthonormalized constraint normals (Nv, m, 3)."""
    coeff = jnp.einsum("vc,vmc->vm", vec, n_hat)
    return vec - jnp.einsum("vm,vmc->vc", coeff, n_hat)


def make_gradient_projector(spec: ProblemSpec) -> Callable | None:
    """Three-channel exact KKT projection.

    1. Local per-vertex rows (pins): analytic 3x3 projectors, O(Nv).
    2. Compact-support rows (rim matching: each row touches <= s vertices):
       the normal-equation matrix is assembled from slot (value, row) pairs
       in O(k^2 s^2) instead of O(k^2 Nv), and the correction is a gather/
       scatter in O(k s).
    3. Dense rows (volume, global areas): the small dense solve as before.

    Channels 2+3 are solved JOINTLY (one KKT system) after premultiplying
    every row by the local projector — mathematically identical to stacking
    all rows densely, since projection onto an intersection of null spaces
    equals projecting onto the local null space and then KKT-solving the
    remaining rows expressed inside it.  The reference pays the dense price
    in NumPy (runtime/constraint_projection.py); at refined kozlov sizes
    the dense form (k ~ #rim rows) went quadratic in mesh size.
    """
    from membrane_solver_tpu.constraints import get_constraint

    if spec.option("rim_slope_match_kkt_rows", "span_reduced").lower() == (
        "reference_exact"
    ):
        rim_flags = spec.static_of("constraint:rim_slope_match_out", ("inactive",))
        if rim_flags[0] == "active" and len(rim_flags) > 1 and bool(rim_flags[1]):
            # Reference-faithful mode: with a disk group the reference stacks
            # the in-condition rim rows as EXACT negations of the out rows,
            # its joint KKT normal matrix (pins + rim rows, one system) is
            # exactly singular (sigma_min ~ 1e-33 recorded on the
            # theory-parity lanes), LAPACK flags it, and the WHOLE
            # projection is skipped every step — the raw gradient drives
            # the line search and constraints act only through post-step
            # enforcement.  The recorded theory-parity baselines are
            # trajectories of that flow, so parity runs opt into the same
            # skip.  The default ("span_reduced") drops the negated
            # duplicates instead and projects on the well-conditioned
            # system — see tests/fixtures/ref_kkt_pathology.json.
            return None

    local_builders = []
    compact_builders = []
    dense_builders = []
    for name in dict.fromkeys(spec.constraint_modules):
        mod = get_constraint(name)
        local_maker = getattr(mod, "make_local_constraint_normals", None)
        local = (
            local_maker(spec)
            if local_maker is not None
            else getattr(mod, "local_constraint_normals", None)
        )
        if local is not None:
            local_builders.append(local)
            continue  # local form supersedes this module's dense rows
        compact_maker = getattr(mod, "make_compact_constraint_rows", None)
        if compact_maker is not None:
            fn = compact_maker(spec)
            if fn is not None:
                compact_builders.append(fn)
                continue  # compact form supersedes this module's dense rows
        maker = getattr(mod, "make_constraint_gradient_rows", None)
        fn = maker(spec) if maker is not None else getattr(mod, "constraint_gradient_rows", None)
        if fn is not None:
            dense_builders.append(fn)
    if not (local_builders or compact_builders or dense_builders):
        return None

    def project(grad, state, topo, params):
        n_hat = None
        if local_builders:
            blocks = [
                b
                for b in (fn(state, topo, params) for fn in local_builders)
                if b is not None
            ]
            if blocks:
                n_hat = orthonormalize_local_normals(jnp.concatenate(blocks, axis=1))
                grad = apply_local_projection(grad, n_hat)

        compact = [
            c for c in (fn(state, topo, params) for fn in compact_builders) if c is not None
        ]
        dense = [
            r for r in (fn(state, topo, params) for fn in dense_builders) if r is not None
        ]
        if not compact and not dense:
            return grad

        n_rows = grad.shape[0]
        vals = rows_c = None
        if compact:
            # pad slot counts to the max so blocks concatenate
            s_max = max(c[0].shape[1] for c in compact)
            vs, rs = [], []
            for v, r in compact:
                if v.shape[1] < s_max:
                    pad = s_max - v.shape[1]
                    v = jnp.pad(v, ((0, 0), (0, pad), (0, 0)))
                    r = jnp.pad(r, ((0, 0), (0, pad)))
                vs.append(v)
                rs.append(r)
            vals = jnp.concatenate(vs, axis=0)  # (kc, s, 3)
            rows_c = jnp.clip(jnp.concatenate(rs, axis=0), 0, n_rows - 1)
            if n_hat is not None:
                # project each slot value by its vertex's local projector
                # (zero-valued padded slots stay zero)
                nh = n_hat[rows_c]  # (kc, s, m, 3)
                coeff = jnp.einsum("ksc,ksmc->ksm", vals, nh)
                vals = vals - jnp.einsum("ksm,ksmc->ksc", coeff, nh)

        dense_rows = None
        if dense:
            dense_rows = jnp.concatenate(dense, axis=0)
            if n_hat is not None:
                dense_rows = jax.vmap(lambda r: apply_local_projection(r, n_hat))(dense_rows)

        if vals is None:
            return project_gradient_kkt(grad, dense_rows)

        kc = vals.shape[0]
        # A_cc from slot matching: rows overlap only where slot vertices agree
        eq = (rows_c[:, None, :, None] == rows_c[None, :, None, :]).astype(grad.dtype)
        dots = jnp.einsum("iac,jbc->ijab", vals, vals)
        A_cc = jnp.sum(dots * eq, axis=(2, 3))
        b_c = jnp.einsum("iac,iac->i", vals, grad[rows_c])

        if dense_rows is None:
            A = A_cc + 1e-18 * jnp.eye(kc, dtype=grad.dtype)
            lam = _solve_kkt_with_rescue(A, b_c, kc)
            corr = jnp.zeros_like(grad).at[rows_c].add(lam[:, None, None] * vals)
            return grad - corr

        kd = dense_rows.shape[0]
        Gd = dense_rows.reshape(kd, -1)
        A_dd = Gd @ Gd.T
        A_cd = jnp.einsum("iac,jiac->ij", vals, dense_rows[:, rows_c])
        A = jnp.block([[A_cc, A_cd], [A_cd.T, A_dd]]) + 1e-18 * jnp.eye(
            kc + kd, dtype=grad.dtype
        )
        b = jnp.concatenate([b_c, Gd @ grad.reshape(-1)])
        lam = _solve_kkt_with_rescue(A, b, kc + kd)
        corr = jnp.zeros_like(grad).at[rows_c].add(lam[:kc, None, None] * vals)
        corr = corr + (lam[kc:] @ Gd).reshape(grad.shape)
        return grad - corr

    return project


# ----------------------------------------------------------------------
# geometric constraint enforcement (hard projections between/inside steps)
# ----------------------------------------------------------------------
def make_constraint_enforcer(spec: ProblemSpec) -> Callable | None:
    """Return enforce(state, topo, params, context: str) -> state, or None.

    Parity: runtime/constraint_manager.py:enforce_all — geometric projections
    (volume Lagrange projection, pins, areas) applied after mesh ops
    (context "mesh_operation"), at finalize, and per line-search trial
    (context "minimize").  The volume projection is skipped in the
    "minimize" context when volume_projection_during_minimization is off
    (constraint_manager.py:877-887); other constraints always enforce.
    ``context`` is a static (trace-time) string.
    """
    key = (spec, "__enforcer__")
    if key in _BLOCK_CACHE:
        return _BLOCK_CACHE[key]
    from membrane_solver_tpu.constraints import get_constraint

    enforcers = []
    for name in dict.fromkeys(spec.constraint_modules):
        mod = get_constraint(name)
        maker = getattr(mod, "make_enforce", None)
        fn = maker(spec) if maker is not None else getattr(mod, "enforce", None)
        if fn is not None:
            enforcers.append((name, fn))
    if not enforcers:
        return None

    def enforce(state, topo, params, context="minimize"):
        for name, fn in enforcers:
            if (
                name == "volume"
                and context == "minimize"
                and not spec.volume_projection_during_minimization
            ):
                continue
            state = fn(state, topo, params, context=context)
        return state

    # jit with the context static: eager per-module enforcement dispatched
    # dozens of tiny device ops per call, whose launch latency
    # dominated the small-lane minimize-entry cost.  (Module concrete-peek
    # helpers are written to work under tracing; see e.g.
    # constraints/pin_to_circle._any_compile_time.)
    _BLOCK_CACHE[key] = jax.jit(enforce, static_argnames=("context",))
    return _BLOCK_CACHE[key]


# ----------------------------------------------------------------------
# line search
# ----------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LineSearchResult:
    success: jnp.ndarray  # bool
    new_step: jnp.ndarray  # f64
    energy: jnp.ndarray  # accepted energy (or energy0 on failure)
    state: MeshState  # accepted state (or the baseline on failure)


def armijo_line_search(
    energy_of_state: Callable,  # MeshState -> scalar
    state: MeshState,
    grad: jnp.ndarray,
    direction: jnp.ndarray,
    step_size: jnp.ndarray,
    energy0: jnp.ndarray,
    movable: jnp.ndarray,  # (Nv,) bool
    topo: Topology,
    state_of_trial: Callable,  # trial positions -> full trial MeshState
    accept_rule: str = "armijo",  # "decrease_only" valid in reduced-LS mode
) -> LineSearchResult:
    """Functional Armijo backtracking (reference line_search.py:261-529).

    Pure trial evaluation: the caller's state is never mutated; the accepted
    state is returned.  Safety: steps displacing any vertex by more than 0.3x
    the min edge length must not rotate any triangle normal by more than
    0.5 rad nor collapse a triangle (checked on the raw trial positions,
    before enforcement).  ``state_of_trial`` reproduces the reference's
    per-trial pipeline: geometric constraint enforcement, kinematic tilt
    constraint enforcement, and tangent re-projection of the tilt fields onto
    the trial surface (line_search.py:440-448 + minimizer._projected_energy).
    Rejected trials implicitly restore everything (the baseline state is
    immutable), matching the reference's snapshot/restore bookkeeping.
    """
    positions = state.positions
    dtype = positions.dtype
    min_edge = dgeo.min_edge_length(positions, topo.edge_rows, topo.edge_valid)
    safe_limit = jnp.where(min_edge > 0, SAFE_STEP_FRACTION * min_edge, jnp.inf)

    dir_norms = jnp.linalg.norm(direction, axis=1)
    max_dir_norm = jnp.max(jnp.where(movable, dir_norms, 0.0))
    g_dot_d = jnp.sum(grad * direction)

    alpha0 = step_size
    alpha_max = LS_ALPHA_MAX_FACTOR * step_size

    def trial_of(alpha):
        return jnp.where(movable[:, None], positions + alpha * direction, positions)

    # Non-descent direction: skip the search entirely (line_search.py:319-322).
    # Under the reduced-LS "decrease_only" accept rule the reference bypasses
    # both the descent skip and the Armijo slope term (line_search.py:110,
    # 170-173): acceptance is E_t <= E0.
    decrease_only = accept_rule == "decrease_only"  # static
    if decrease_only:
        descent = jnp.asarray(True)
        slope = jnp.asarray(0.0, dtype)
    else:
        descent = g_dot_d < 0.0
        slope = g_dot_d

    def cond(carry):
        k, alpha, done, success, _, _ = carry
        return (~done) & (k < LS_MAX_ITER)

    def body(carry):
        k, alpha, done, success, acc_E, acc_alpha = carry
        trial = trial_of(alpha)
        is_safe_small = (alpha * max_dir_norm) < safe_limit
        normals_ok = is_safe_small | dgeo.check_normal_rotation(
            positions, trial, topo.tri_rows, topo.tri_valid, NORMAL_LIMIT_RADIANS
        )

        def eval_and_decide(_):
            E_t = energy_of_state(state_of_trial(trial))
            accept = E_t <= energy0 + LS_C * alpha * slope
            if os.environ.get("MEMBRANE_DEBUG_LS") == "1":  # trace-time gate
                jax.debug.print(
                    "LS trial alpha={a:.6e} E_t={e:.12f} thresh={t:.12f} "
                    "accept={ok}",
                    a=alpha, e=E_t,
                    t=energy0 + LS_C * alpha * slope, ok=accept,
                )
            return accept, E_t

        accept, E_t = jax.lax.cond(
            normals_ok,
            eval_and_decide,
            lambda _: (jnp.asarray(False), jnp.asarray(jnp.inf, dtype)),
            None,
        )

        new_alpha = jnp.where(accept, alpha, alpha * LS_BETA)
        new_done = accept | (new_alpha < LS_ALPHA_FLOOR)
        return (
            k + 1,
            new_alpha,
            new_done,
            success | accept,
            jnp.where(accept, E_t, acc_E),
            jnp.where(accept, alpha, acc_alpha),
        )

    init = (
        jnp.asarray(0),
        alpha0,
        ~descent,  # done immediately when not a descent direction
        jnp.asarray(False),
        energy0,
        jnp.asarray(0.0, dtype),
    )
    k, alpha, done, success, acc_E, acc_alpha = jax.lax.while_loop(cond, body, init)
    success = success & descent

    accepted_state = state_of_trial(trial_of(acc_alpha))
    final_state = jax.tree_util.tree_map(
        lambda a, b: jnp.where(success, a, b), accepted_state, state
    )
    new_step = jnp.where(
        success,
        jnp.minimum(acc_alpha * LS_GAMMA, alpha_max),
        jnp.where(descent, jnp.maximum(alpha * LS_BETA, step_size * LS_BETA), step_size),
    )
    final_E = jnp.where(success, acc_E, energy0)
    return LineSearchResult(
        success=success, new_step=new_step, energy=final_E, state=final_state
    )


# ----------------------------------------------------------------------
# steppers (functional state)
# ----------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StepperState:
    """Carry for CG (prev grad/direction) and BFGS (prev x + dense H^-1).

    GD ignores everything.  Kept at fixed shapes so one pytree serves each
    compiled (spec, options) pair; the H block exists only for BFGS blocks.
    """

    prev_grad: jnp.ndarray  # (Nv, 3)
    prev_dir: jnp.ndarray  # (Nv, 3)  [CG]
    prev_x: jnp.ndarray | None  # (Nv, 3)  [BFGS]
    H: jnp.ndarray | None  # (3Nv, 3Nv) inverse-Hessian approx [BFGS]
    have_prev: jnp.ndarray  # bool
    iter_count: jnp.ndarray  # int32: successful steps since last reset


def fresh_stepper_state(nv_cap: int, dtype=None, kind: str = "gradient_descent") -> StepperState:
    from membrane_solver_tpu.utils.precision import default_float

    if dtype is None:
        dtype = default_float()
    z = jnp.zeros((nv_cap, 3), dtype=dtype)
    bfgs = kind == "bfgs"
    return StepperState(
        prev_grad=z,
        prev_dir=z,
        prev_x=z if bfgs else None,
        H=jnp.eye(3 * nv_cap, dtype=dtype) if bfgs else None,
        have_prev=jnp.asarray(False),
        iter_count=jnp.asarray(0, jnp.int32),
    )


CG_RESTART_INTERVAL = 10


def stepper_direction(
    kind: str,
    grad: jnp.ndarray,
    ss: StepperState,
    fixed_mask: jnp.ndarray,
    positions: jnp.ndarray,
) -> Tuple[jnp.ndarray, StepperState]:
    """Descent direction for the active stepper kind (static switch).

    - CG parity (conjugate_gradient.py:62-117): *per-vertex-row*
      Polak-Ribiere beta with per-row reset to steepest descent where
      beta < 0; full restart to -g with no history or every 10th successful
      step; fixed rows zeroed.
    - BFGS parity (bfgs.py:88-124): dense inverse-Hessian over movable DOFs
      (realized full-size with masked s/y so fixed/padded rows stay at
      identity), update V H V^T + rho s s^T when the curvature condition
      y.s > 1e-12 holds, else reset H to identity; direction -H g.

    Returns (direction, mid-state).  BFGS mutates H at direction time like the
    reference; prev_x/prev_grad are stored only on success (the Minimizer
    resets everything on failures/repairs, matching reference reset()).
    """
    if kind == "gradient_descent":
        return -grad, ss
    if kind == "conjugate_gradient":
        numer = jnp.sum(grad * (grad - ss.prev_grad), axis=1)
        denom = jnp.sum(ss.prev_grad * ss.prev_grad, axis=1) + 1e-20
        beta_pr = numer / denom
        cg_dir = -grad + beta_pr[:, None] * ss.prev_dir
        cg_dir = jnp.where((beta_pr < 0)[:, None], -grad, cg_dir)
        restart = (~ss.have_prev) | (ss.iter_count % CG_RESTART_INTERVAL == 0)
        direction = jnp.where(restart, -grad, cg_dir)
        return jnp.where(fixed_mask[:, None], 0.0, direction), ss
    if kind == "bfgs":
        n = grad.shape[0]
        movable = (~fixed_mask)[:, None].astype(grad.dtype)
        x = (positions * movable).reshape(-1)
        g = (grad * movable).reshape(-1)
        s = x - (ss.prev_x * movable).reshape(-1)
        y = g - (ss.prev_grad * movable).reshape(-1)
        ys = jnp.dot(y, s)
        eye = jnp.eye(3 * n, dtype=grad.dtype)

        def updated_H(_):
            rho = 1.0 / ys
            V = eye - rho * jnp.outer(s, y)
            return V @ ss.H @ V.T + rho * jnp.outer(s, s)

        H_after = jax.lax.cond(
            ss.have_prev,
            lambda _: jax.lax.cond(ys > 1e-12, updated_H, lambda _: eye, None),
            lambda _: ss.H,
            None,
        )
        direction = -(H_after @ g).reshape(n, 3)
        direction = jnp.where(fixed_mask[:, None], 0.0, direction)
        return direction, dataclasses.replace(ss, H=H_after)
    raise ValueError(f"unknown stepper kind {kind!r}")


def stepper_update_on_success(
    kind: str,
    ss: StepperState,
    grad: jnp.ndarray,
    direction: jnp.ndarray,
    positions: jnp.ndarray,
) -> StepperState:
    if kind == "gradient_descent":
        return ss
    return dataclasses.replace(
        ss,
        prev_grad=grad,
        prev_dir=direction,
        prev_x=positions if ss.prev_x is not None else None,
        have_prev=jnp.asarray(True),
        iter_count=ss.iter_count + 1,
    )


# ----------------------------------------------------------------------
# minimize block
# ----------------------------------------------------------------------
@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MinimizeStats:
    iterations: jnp.ndarray  # int32 completed iterations in this block
    energy: jnp.ndarray  # last assembled energy (pre-step of final iter)
    accepted_energy: jnp.ndarray
    grad_norm: jnp.ndarray
    step_size: jnp.ndarray
    step_success: jnp.ndarray  # bool
    converged: jnp.ndarray  # bool
    terminated_early: jnp.ndarray  # bool (zero-step exit)
    zero_step_counter: jnp.ndarray  # int32 (carried across blocks)


@dataclasses.dataclass(frozen=True)
class MinimizeOptions:
    """Static compile-time switches for a minimize block."""

    stepper: str = "gradient_descent"
    step_size_mode: str = "adaptive"  # or "fixed"
    enforce_in_line_search: bool = False
    # lagrange mode without per-trial geometric volume projection: check the
    # post-step volume drift and hard-project when it exceeds volume_tolerance
    # (minimizer.py:1464-1499)
    volume_drift_check: bool = False


def _guarded_relax_body(spec, relax_fn, total, state, topo, params, n_inner):
    """Leaflet tilt relax under the energy-spike guard (minimizer.py:1228-1288).

    Shared by the minimize block's per-iteration relax and by the host-side
    pre-scan relax on theta_B-optimize iterations (reference order per
    iteration: tilt relax -> theta scan -> shape step, minimizer.py:1226-1298).
    """
    dtype = state.positions.dtype
    t_step = params.get("tilt_step_size", jnp.asarray(0.0, dtype))
    t_tol = params.get("tilt_tol", jnp.asarray(0.0, dtype))
    guard_factor = params.get("tilt_relax_energy_guard_factor", jnp.asarray(0.0, dtype))
    guard_min = params.get("tilt_relax_energy_guard_min", jnp.asarray(0.0, dtype))

    def plain(state):
        new_state, _stats = relax_fn(state, topo, params, n_inner, t_step, t_tol)
        return new_state

    def guarded(state):
        pre_E = total(state, topo, params)
        threshold = jnp.maximum(guard_min, jnp.abs(pre_E) * guard_factor)

        # 1 + tilt_relax_energy_guard_retries (default 4; reference
        # minimizer.py:1241) attempts with a halved tilt step on each
        # spike; roll back fully if all spike.  A while_loop keeps ONE
        # relax instance in the program (an unrolled retry chain
        # quintuples the largest subprogram and dominated XLA compile
        # time at refined mesh sizes) and exits on the first accepted
        # trial — identical result.
        max_attempts = 1 + jnp.asarray(
            params.get("tilt_relax_energy_guard_retries", jnp.asarray(4.0, dtype)),
            jnp.int32,
        )

        def retry_cond(carry):
            attempt, accepted, _step, _result = carry
            return (~accepted) & (attempt < max_attempts)

        def retry_body(carry):
            attempt, accepted, trial_step, result = carry
            new_st, _ = relax_fn(state, topo, params, n_inner, trial_step, t_tol)
            post_E = total(new_st, topo, params)
            ok = post_E <= threshold
            result = jax.tree_util.tree_map(
                lambda a, b: jnp.where(ok, a, b), new_st, result
            )
            return attempt + 1, ok, trial_step * 0.5, result

        _n, accepted, _s, result = jax.lax.while_loop(
            retry_cond,
            retry_body,
            (jnp.asarray(0, jnp.int32), jnp.asarray(False), t_step, state),
        )
        return jax.tree_util.tree_map(
            lambda a, b: jnp.where(accepted, a, b), result, state
        )

    if spec.option("tilt_guard", "off") != "on":
        return plain(state)  # static: skip tracing the guarded branch
    return jax.lax.cond(guard_factor > 0.0, guarded, plain, state)


def make_guarded_relax(spec: ProblemSpec) -> Callable:
    """Jitted standalone guarded leaflet relax (memoized per spec).

    Used by the minimizer to run iteration i's tilt relax BEFORE the theta_B
    scan on scan-due iterations, after which the minimize block is told to
    skip its own first-iteration relax (reference runtime ordering:
    minimizer.py:1226 relax -> :1298 _optimize_thetaB_scalar -> :1360 step).
    """
    key = (spec, "__guarded_relax__")
    if key in _BLOCK_CACHE:
        return _BLOCK_CACHE[key]
    from membrane_solver_tpu.runtime import tilt_relax as _tr

    relax_fn = _tr.make_relax_leaflet_tilts(spec)
    total = make_total_energy(spec)

    def run(state, topo, params, n_inner):
        return _guarded_relax_body(spec, relax_fn, total, state, topo, params, n_inner)

    _BLOCK_CACHE[key] = jax.jit(run)
    return _BLOCK_CACHE[key]


def _minimize_block_impl(
    spec: ProblemSpec,
    options: MinimizeOptions,
    state: MeshState,
    topo: Topology,
    params: Dict,
    stepper_state: StepperState,
    n_steps: jnp.ndarray,
    step_size: jnp.ndarray,
    fixed_step: jnp.ndarray,
    tol: jnp.ndarray,
    step_size_floor: jnp.ndarray,
    max_zero_steps: jnp.ndarray,
    zero_step_counter: jnp.ndarray,
    tilt_inner_iters: jnp.ndarray | None = None,
    skip_first_relax: jnp.ndarray | None = None,
):
    total = make_total_energy(spec)
    energy_of_positions = make_energy_of_positions(spec)
    gradient_projector = make_gradient_projector(spec)
    enforcer = make_constraint_enforcer(spec) if options.enforce_in_line_search else None
    dtype = state.positions.dtype

    # leaflet tilt inner solve, statically gated (minimizer.py:1224-1294)
    from membrane_solver_tpu.runtime import tilt_relax as _tr

    tilt_mode = spec.option("tilt_solve_mode", "fixed").lower()
    do_tilt_relax = (
        _tr.spec_uses_leaflet_tilts(spec)
        and tilt_mode in {"nested", "coupled"}
        and tilt_inner_iters is not None
    )
    relax_fn = _tr.make_relax_leaflet_tilts(spec) if do_tilt_relax else None
    # single-field path (reference minimizer.py:1294 else-branch)
    do_vertex_tilt_relax = (
        not _tr.spec_uses_leaflet_tilts(spec)
        and _tr.spec_uses_vertex_tilts(spec)
        and tilt_mode in {"nested", "coupled"}
        and tilt_inner_iters is not None
    )
    vertex_relax_fn = _tr.make_relax_vertex_tilts(spec) if do_vertex_tilt_relax else None
    project_tilts_after_step = do_tilt_relax or _tr.spec_uses_vertex_tilts(spec)
    tilt_enforcer = _tr.make_tilt_enforcer(spec)
    # reduced-energy line search (reference minimizer._trial_projected_energy
    # with line_search_reduced_energy): every trial re-relaxes the leaflet
    # tilts for a bounded number of inner steps before scoring, and the
    # accepted trial keeps the relaxed tilts.  Without it, coupled
    # shape+tilt descent directions (e.g. the theory-parity disk lift)
    # score as energy increases and every shape step is rejected.
    reduced_ls = do_tilt_relax and spec.option(
        "line_search_reduced_energy", ""
    ).lower() in {"1", "true", "yes", "on"}
    if reduced_ls:
        _rule = spec.option("line_search_reduced_accept_rule", "armijo").lower()
        if _rule not in ("armijo", "decrease_only"):
            raise ValueError(f"Unknown reduced-energy accept rule: {_rule!r}")

    def relax_with_guard(state):
        """Energy-spike guard with tilt-step halving (minimizer.py:1228-1288)."""
        return _guarded_relax_body(
            spec, relax_fn, total, state, topo, params, tilt_inner_iters
        )

    energy_vg = make_energy_vg(spec)
    # curved free-disk lanes: restrict shape descent to height DOFs and zero
    # the artificial support-transition rows (reference
    # runtime/projections/curved_disk.py:14-54), statically gated
    curved_disk_mode = (
        spec.option("rim_slope_match_mode", "").lower() == "shared_rim_staggered_v1"
    )

    def value_and_grad_projected(state):
        E, g = energy_vg(state.positions, state, topo, params)
        E = jnp.asarray(E, dtype)
        # KKT projection sees the un-zeroed gradient and full constraint
        # gradients; fixed rows are zeroed afterwards (minimizer.py:984-989).
        if gradient_projector is not None:
            g = gradient_projector(g, state, topo, params)
        # Curved free-disk DOF restriction AFTER the constraint projection
        # (reference runtime/minimizer.py:1302-1303 applies
        # project_curved_free_disk_shape_dofs after project_constraints_array)
        # so pin normals/constraint rows with lateral components cannot
        # reintroduce x/y descent.
        if curved_disk_mode and "core:curved_disk/transition_mask" in topo.extras:
            g = g.at[:, :2].set(0.0)
            trans = topo.extras["core:curved_disk/transition_mask"]
            g = g.at[:, 2].set(jnp.where(trans, 0.0, g[:, 2]))
        g = jnp.where(topo.fixed_mask[:, None], 0.0, g)
        return E, g

    movable = ~topo.fixed_mask

    def cond(carry):
        (state, ss, i, step_size, zero_steps, done, *_rest) = carry
        return (~done) & (i < n_steps)

    def body(carry):
        (
            state,
            ss,
            i,
            step_size,
            zero_steps,
            done,
            converged,
            terminated_early,
            step_success,
            last_E,
            last_acc_E,
            last_gnorm,
        ) = carry

        if do_tilt_relax:
            if skip_first_relax is not None:
                # On theta_B-scan iterations the minimizer already ran this
                # iteration's relax (reference order: relax -> scan -> step);
                # re-relaxing here would double-relax iteration 0.
                state = jax.lax.cond(
                    (i == 0) & (skip_first_relax != 0),
                    lambda s: s,
                    relax_with_guard,
                    state,
                )
            else:
                state = relax_with_guard(state)
        elif do_vertex_tilt_relax:
            t_step = params.get("tilt_step_size", jnp.asarray(0.0, dtype))
            t_tol = params.get("tilt_tol", jnp.asarray(0.0, dtype))
            state, _nacc = vertex_relax_fn(
                state, topo, params, tilt_inner_iters, t_step, t_tol
            )

        E, grad = value_and_grad_projected(state)
        gnorm = jnp.linalg.norm(grad)
        now_converged = gnorm < tol

        def do_step(_):
            fixed_mode = options.step_size_mode == "fixed"  # static switch
            step_in = fixed_step if fixed_mode else step_size
            direction, ss_mid = stepper_direction(
                options.stepper, grad, ss, topo.fixed_mask, state.positions
            )

            # Reduced-LS baseline semantics (reference line_search.py:288 +
            # minimizer_helpers._evaluate): energy0 = energy_fn() runs the
            # reduced relax at the BASE positions *before* the tilt snapshot
            # is taken, so the (+reduced_steps) tilts persist — they are the
            # Armijo threshold state, every trial's starting tilts, and the
            # tilts kept on total failure.  The shape gradient/direction is
            # NOT recomputed on that state (the reference computes it before
            # stepper.step).  Scoring projects the tilt fields to the base
            # tangent planes first (minimizer._projected_energy:581-586).
            if reduced_ls:
                _n0 = jnp.asarray(
                    params.get("line_search_reduced_tilt_inner_steps", 10.0),
                    jnp.int32,
                )
                _ts0 = params.get("tilt_step_size", jnp.asarray(0.1, dtype))
                _tt0 = params.get("tilt_tol", jnp.asarray(0.0, dtype))
                ls_base, _r0 = relax_fn(state, topo, params, _n0, _ts0, _tt0)
                _tg0 = dgeo.triangle_geometry(
                    ls_base.positions, topo.tri_rows, topo.tri_valid
                )
                _nrm0 = dgeo.vertex_normals(
                    _tg0, topo.tri_rows, topo.tri_valid, ls_base.positions.shape[0]
                )
                ls_base = dataclasses.replace(
                    ls_base,
                    tilts=dgeo.project_to_tangent(ls_base.tilts, _nrm0),
                    tilts_in=dgeo.project_to_tangent(ls_base.tilts_in, _nrm0),
                    tilts_out=dgeo.project_to_tangent(ls_base.tilts_out, _nrm0),
                )
                ls_E0 = total(ls_base, topo, params)
            else:
                ls_base = state
                ls_E0 = E

            def state_of_trial(p):
                # Per-trial pipeline (line_search.py:440-448 +
                # minimizer._projected_energy / _trial_projected_energy):
                # geometric enforcement, kinematic tilt-constraint enforcement
                # (e.g. rim slope re-matching against the *trial* slopes), then
                # tangent re-projection of all tilt fields onto the trial
                # surface.  Tilts mutated by a rejected trial are implicitly
                # restored (the baseline state is immutable); the accepted
                # trial's tilts are kept — this tilt/shape coupling is what
                # makes shape steps acceptable on tilt-bearing meshes.
                # Trials start from ls_base (== state unless reduced-LS,
                # where the baseline carries the energy0 relax's tilts).
                st = dataclasses.replace(ls_base, positions=p)
                if enforcer is not None:
                    st = enforcer(st, topo, params, context="minimize")
                    st = tilt_enforcer(st, topo, params)
                if reduced_ls:
                    n_inner = jnp.asarray(
                        params.get("line_search_reduced_tilt_inner_steps", 10.0),
                        jnp.int32,
                    )
                    t_step = params.get("tilt_step_size", jnp.asarray(0.1, dtype))
                    t_tol = params.get("tilt_tol", jnp.asarray(0.0, dtype))
                    st, _rstats = relax_fn(st, topo, params, n_inner, t_step, t_tol)
                if project_tilts_after_step:
                    t_geo = dgeo.triangle_geometry(
                        st.positions, topo.tri_rows, topo.tri_valid
                    )
                    nrm = dgeo.vertex_normals(
                        t_geo, topo.tri_rows, topo.tri_valid, st.positions.shape[0]
                    )
                    st = dataclasses.replace(
                        st,
                        tilts=dgeo.project_to_tangent(st.tilts, nrm),
                        tilts_in=dgeo.project_to_tangent(st.tilts_in, nrm),
                        tilts_out=dgeo.project_to_tangent(st.tilts_out, nrm),
                    )
                return st

            # reduced-LS accept-rule override (reference minimizer.py:1348-1354
            # -> line_search.py:110,170-173): only honored when the reduced
            # line search is active
            ls_accept_rule = (
                spec.option("line_search_reduced_accept_rule", "armijo").lower()
                if reduced_ls
                else "armijo"
            )
            ls = armijo_line_search(
                lambda st: total(st, topo, params),
                ls_base,
                grad,
                direction,
                step_in,
                ls_E0,
                movable,
                topo,
                state_of_trial,
                accept_rule=ls_accept_rule,
            )
            # rejected-shape-step scaffold fallback (reference
            # minimizer.py:298-428): on rejection, retry the line search
            # along a direction that only moves the trace_layer rows in -z
            # of their gradient; attempted only if the mean trace-z descent
            # component is positive.  Statically gated on the gp switch.
            if (
                spec.option("shape_scaffold_rejected_step_fallback", "off").lower()
                == "trace_z"
                and "core:scaffold_trace/mask" in topo.extras
            ):
                trace_mask = topo.extras["core:scaffold_trace/mask"]
                fb_dir = jnp.zeros_like(grad).at[:, 2].set(
                    jnp.where(trace_mask, -grad[:, 2], 0.0)
                )
                n_trace = jnp.maximum(jnp.sum(trace_mask.astype(dtype)), 1.0)
                dz_mean = jnp.sum(fb_dir[:, 2]) / n_trace
                viable = (~ls.success) & jnp.isfinite(dz_mean) & (dz_mean > 0.0)

                def fb_search(_):
                    return armijo_line_search(
                        lambda st: total(st, topo, params),
                        ls_base,
                        grad,
                        fb_dir,
                        step_in,
                        ls_E0,
                        movable,
                        topo,
                        state_of_trial,
                    )

                def keep_ls(_):
                    return ls

                ls = jax.lax.cond(viable, fb_search, keep_ls, None)
            new_state = ls.state
            if options.volume_drift_check:
                strong_enforce = make_constraint_enforcer(spec)
                vols = dgeo.body_volumes(
                    new_state.positions,
                    topo.tri_rows,
                    topo.tri_valid,
                    topo.tri_body,
                    spec.nb_cap,
                )
                active = topo.body_valid & topo.body_has_target
                rel = jnp.abs(vols - topo.body_target_volume) / jnp.maximum(
                    jnp.abs(topo.body_target_volume), 1.0
                )
                max_rel = jnp.max(jnp.where(active, rel, 0.0))
                vol_tol = params.get("volume_tolerance", jnp.asarray(1e-3))
                drifted = ls.success & (max_rel > vol_tol)
                projected = strong_enforce(new_state, topo, params, context="mesh_operation")
                new_state = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(drifted, a, b), projected, new_state
                )
            else:
                drifted = jnp.asarray(False)
            new_step_size = fixed_step if fixed_mode else ls.new_step
            # zero-step bookkeeping (minimizer.py:1425-1452); the floor check
            # uses the post-update (post-mode) step size.
            at_floor = new_step_size <= step_size_floor
            new_zero = jnp.where(
                ls.success,
                0,
                jnp.where(at_floor, zero_steps + 1, 0),
            ).astype(zero_steps.dtype)
            early = (~ls.success) & at_floor & (new_zero >= max_zero_steps)
            # history stored only on success; reset on failure or post-drift
            # projection (minimizer.py:1448-1450, 1497-1499)
            reset_ss = jax.lax.cond(
                ls.success & ~drifted,
                lambda: stepper_update_on_success(
                    options.stepper, ss_mid, grad, direction, state.positions
                ),
                lambda: fresh_stepper_state(spec.nv_cap, dtype, options.stepper),
            )
            return (
                new_state,
                reset_ss,
                new_step_size,
                new_zero,
                early,
                ls.success,
                ls.energy,
            )

        def skip_step(_):
            return (state, ss, step_size, zero_steps, jnp.asarray(False), jnp.asarray(True), E)

        (
            new_state,
            new_ss,
            new_step_size,
            new_zero,
            early,
            success,
            acc_E,
        ) = jax.lax.cond(now_converged, skip_step, do_step, None)

        new_done = now_converged | early
        return (
            new_state,
            new_ss,
            i + 1,
            new_step_size,
            new_zero,
            new_done,
            now_converged,
            early,
            success,
            E,
            acc_E,
            gnorm,
        )

    zero_i32 = jnp.asarray(0, jnp.int32)
    init = (
        state,
        stepper_state,
        zero_i32,
        jnp.asarray(step_size, dtype),
        jnp.asarray(zero_step_counter, jnp.int32),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.asarray(True),
        jnp.asarray(0.0, dtype),
        jnp.asarray(0.0, dtype),
        jnp.asarray(0.0, dtype),
    )
    (
        state,
        ss,
        i,
        step_size,
        zero_steps,
        done,
        converged,
        terminated_early,
        step_success,
        last_E,
        last_acc_E,
        last_gnorm,
    ) = jax.lax.while_loop(cond, body, init)

    stats = MinimizeStats(
        iterations=i,
        energy=last_E,
        accepted_energy=last_acc_E,
        grad_norm=last_gnorm,
        step_size=step_size,
        step_success=step_success,
        converged=converged,
        terminated_early=terminated_early,
        zero_step_counter=zero_steps,
    )
    return state, ss, stats


_BLOCK_CACHE: Dict[Tuple, Callable] = {}


def minimize_block(spec: ProblemSpec, options: MinimizeOptions) -> Callable:
    """Jitted minimize block for a given static (spec, options).

    Wrapped in the disk-backed AOT export cache: the block is the largest
    traced graph in the system and its per-process trace+lower cost
    dominated the small interactive lanes (utils/aot_cache.py).
    """
    key = (spec, options)
    if key not in _BLOCK_CACHE:
        from membrane_solver_tpu.utils.aot_cache import aot_wrap

        _BLOCK_CACHE[key] = aot_wrap(
            "minimize_block",
            f"{spec!r}|{options!r}",
            jax.jit(partial(_minimize_block_impl, spec, options)),
        )
    return _BLOCK_CACHE[key]


@jax.jit
def project_all_tilts(state: MeshState, topo: Topology) -> MeshState:
    """Tangent-project all three tilt fields (minimize boundary hygiene)."""
    geo = dgeo.triangle_geometry(state.positions, topo.tri_rows, topo.tri_valid)
    nrm = dgeo.vertex_normals(geo, topo.tri_rows, topo.tri_valid, state.positions.shape[0])
    return dataclasses.replace(
        state,
        tilts=dgeo.project_to_tangent(state.tilts, nrm),
        tilts_in=dgeo.project_to_tangent(state.tilts_in, nrm),
        tilts_out=dgeo.project_to_tangent(state.tilts_out, nrm),
    )


def make_energy_value(spec: ProblemSpec) -> Callable:
    """Jitted total-energy evaluation for a spec (AOT-cached)."""
    key = (spec, "__energy__")
    if key not in _BLOCK_CACHE:
        from membrane_solver_tpu.utils.aot_cache import aot_wrap

        _BLOCK_CACHE[key] = aot_wrap(
            "energy_value", repr(spec), jax.jit(make_total_energy(spec))
        )
    return _BLOCK_CACHE[key]


def make_energy_breakdown(spec: ProblemSpec) -> Callable:
    """Jitted per-module energy breakdown: fn(state, topo, params) -> dict.

    One device program instead of per-module eager dispatch — the theta_B
    scan records a full breakdown per candidate (reference
    tilt_optimization.py:92), which made eager evaluation the scan's
    dominant cost on scan-every-iteration lanes.  Scales follow
    :func:`module_scale_fn` like every other evaluation path.
    """
    key = (spec, "__energy_breakdown__")
    if key not in _BLOCK_CACHE:
        names = active_energy_modules(spec)
        fns = []
        for name in names:
            module = get_module(name)
            maker = getattr(module, "make_energy", None)
            fns.append(
                (name, maker(spec) if maker is not None else module.energy,
                 module_scale_fn(spec, name))
            )

        def breakdown(state: MeshState, topo: Topology, params: Dict):
            geo = dgeo.triangle_geometry(state.positions, topo.tri_rows, topo.tri_valid)
            dtype = state.positions.dtype
            out = {}
            for name, fn, sc in fns:
                term = fn(geo, state, topo, params)
                if sc is not None:
                    term = sc(params, dtype) * term
                out[name] = term
            return out

        _BLOCK_CACHE[key] = jax.jit(breakdown)
    return _BLOCK_CACHE[key]


def make_energy_and_grad(spec: ProblemSpec) -> Callable:
    """Jitted (E, projected grad) evaluation matching the in-loop assembly."""
    key = (spec, "__energy_grad__")
    if key not in _BLOCK_CACHE:
        energy_vg = make_energy_vg(spec)
        gradient_projector = make_gradient_projector(spec)

        def impl(state, topo, params):
            E, g = energy_vg(state.positions, state, topo, params)
            if gradient_projector is not None:
                g = gradient_projector(g, state, topo, params)
            g = jnp.where(topo.fixed_mask[:, None], 0.0, g)
            return E, g

        _BLOCK_CACHE[key] = jax.jit(impl)
    return _BLOCK_CACHE[key]
