"""Host orchestration of the jitted minimization loop.

Parity: reference ``runtime/minimizer.py`` (Minimizer.minimize outer loop,
energy/gradient entry points, constraint enforcement after mesh ops,
auto mesh-quality repair cadence, zero-step early termination).

Division of labor: the per-iteration numerics run on device in
blocks of up to ``mesh_quality_auto_repair_every`` iterations
(`jit_core.minimize_block`); this class owns mesh compilation, chunk
scheduling, the host-side quality-repair/equiangulation hook, and result
bookkeeping.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import jax.numpy as jnp
import numpy as np

from membrane_solver_tpu.constraints import ConstraintModuleManager, get_constraint
from membrane_solver_tpu.core.parameters import GlobalParameters, ParameterResolver
from membrane_solver_tpu.device.state import (
    CompiledProblem,
    build_params,
    compile_state,
    writeback,
)
from membrane_solver_tpu.energy import EnergyModuleManager, get_module
from membrane_solver_tpu.geometry.mesh import Mesh
from membrane_solver_tpu.runtime import jit_core
from membrane_solver_tpu.runtime.steppers import BaseStepper, GradientDescent

logger = logging.getLogger("membrane_solver_tpu")


class Minimizer:
    def __init__(
        self,
        mesh: Mesh,
        global_params: Optional[GlobalParameters] = None,
        stepper: Optional[BaseStepper] = None,
        energy_manager: Optional[EnergyModuleManager] = None,
        constraint_manager: Optional[ConstraintModuleManager] = None,
        energy_modules=None,
        constraint_modules=None,
        step_size: float = 1e-3,
        tol: float = 1e-6,
        quiet: bool = False,
    ):
        self.mesh = mesh
        self.global_params = global_params if global_params is not None else mesh.global_parameters
        self.stepper = stepper if stepper is not None else GradientDescent()
        self.step_size = float(step_size)
        self.tol = float(tol)
        self.quiet = quiet
        self.param_resolver = ParameterResolver(self.global_params)

        names = list(energy_modules if energy_modules is not None else mesh.energy_modules)
        self.energy_module_names = names
        self.energy_manager = energy_manager if energy_manager is not None else EnergyModuleManager(names)
        self.energy_modules = [self.energy_manager.get_module(n) for n in names]

        cons = list(
            constraint_modules if constraint_modules is not None else mesh.constraint_modules
        )
        self.constraint_module_names = cons
        self.constraint_manager = (
            constraint_manager if constraint_manager is not None else ConstraintModuleManager(cons)
        )
        self.constraint_modules = [get_constraint(n) for n in cons]
        self._has_enforceable_constraints = any(
            hasattr(m, "enforce") or hasattr(m, "make_enforce")
            for m in self.constraint_modules
        )

        self._problem: Optional[CompiledProblem] = None
        self._stepper_state = None
        self._params_fingerprint = None
        # recipe pre-planned capacity floors (runtime/capacity_plan.py):
        # when set, every compile_state pads straight to the recipe's
        # final capacity so jitted blocks trace once per process
        self.capacity_floors: Optional[dict] = None

    # ------------------------------------------------------------------
    # compilation plumbing
    # ------------------------------------------------------------------
    @property
    def max_zero_steps(self) -> int:
        return int(self.global_params.get("max_zero_steps", 10))

    @property
    def step_size_floor(self) -> float:
        return float(self.global_params.get("step_size_floor", 1e-8))

    def invalidate(self) -> None:
        """Force recompilation of device arrays from the host mesh."""
        self._problem = None
        self._stepper_state = None

    def set_mesh(self, mesh: Mesh) -> None:
        self.mesh = mesh
        self.invalidate()

    def _only_dynamic_keys_changed(self, fp) -> bool:
        """True when the gp fingerprint diff touches only dynamic-only keys."""
        old = dict(self._params_fingerprint)
        new = dict(fp)
        changed = {k for k in old.keys() | new.keys() if old.get(k) != new.get(k)}
        return bool(changed) and changed <= self._DYNAMIC_ONLY_GP_KEYS

    def reset_soa_caches(self) -> None:  # reference-compatible name
        self.invalidate()

    # gp keys consumed ONLY as dynamic params (device/state.build_params)
    # at call time — never by compile_topology/compile_static hooks or the
    # spec.  A change in these must refresh problem.params, not recompile:
    # the thetaB scan (runtime/tilt_optimization.py) and the closed-form
    # update_scalar_params hook (energy/tilt_thetaB_contact_in.py:271)
    # write tilt_thetaB_value every outer iteration, and a full
    # compile_state rebuild per write dominated the theta-optimize lanes
    # (~100 ms host work x 120 iterations on flat_disk_tilt_mass_mode).
    _DYNAMIC_ONLY_GP_KEYS = frozenset({"tilt_thetaB_value"})

    def _fingerprint_params(self):
        gp = self.global_params.to_dict()
        return tuple(sorted((k, repr(v)) for k, v in gp.items()))

    def problem(self) -> CompiledProblem:
        fp = self._fingerprint_params()
        # Host mesh mutated in place (vertex_average, set-commands, manual
        # edits) or swapped: the device state is stale — drop it WITHOUT
        # writeback (the host is the source of truth for host-side edits).
        # the token holds the mesh OBJECT: object identity cannot be
        # recycled while referenced (unlike id()), and a deepcopy still
        # compares unequal
        mesh_token = (self.mesh, getattr(self.mesh, "_version", 0))
        if self._problem is not None and mesh_token != getattr(self, "_mesh_token", None):
            self._problem = None
        self._mesh_token = mesh_token
        if self._problem is None or fp != self._params_fingerprint:
            if (
                self._problem is not None
                and self._params_fingerprint is not None
                and self._only_dynamic_keys_changed(fp)
            ):
                from membrane_solver_tpu.device.state import build_params

                self._problem.params = build_params(self.mesh)
                self._params_fingerprint = fp
                return self._problem
            if self._problem is not None:
                # keep device-evolved state: sync host first
                writeback(self._problem, self.mesh)
            self._problem = compile_state(self.mesh, min_caps=self.capacity_floors)
            # module lists can be overridden relative to the mesh
            import dataclasses as _dc

            self._problem.spec = _dc.replace(
                self._problem.spec,
                energy_modules=tuple(self.energy_module_names),
                constraint_modules=tuple(self.constraint_module_names),
                volume_mode=str(self.global_params.get("volume_constraint_mode", "lagrange")),
                volume_projection_during_minimization=bool(
                    self.global_params.get("volume_projection_during_minimization", True)
                ),
            )
            self._params_fingerprint = fp
            self._stepper_state = jit_core.fresh_stepper_state(
                self._problem.spec.nv_cap, kind=self.stepper.name
            )
        return self._problem

    def _sync_host(self) -> None:
        if self._problem is not None:
            writeback(self._problem, self.mesh)

    def _project_tilts_device(self, p: CompiledProblem):
        """Tangent-project all tilt fields on device (MeshState -> MeshState).

        Same arithmetic as the host mesh.project_tilts_to_tangent(): per
        vertex, t -= (t . n) n with area-weighted unit vertex normals
        (zero-normal rows are no-ops in both paths).  Skipped entirely when
        no tilt module is active — the fields stay zero and the projection
        is the identity (the reference's host path early-outs on all-zero
        tilts the same way).
        """
        from membrane_solver_tpu.runtime import tilt_relax as _tr

        if not (
            _tr.spec_uses_leaflet_tilts(p.spec) or _tr.spec_uses_vertex_tilts(p.spec)
        ):
            return p.state
        return jit_core.project_all_tilts(p.state, p.topo)

    # ------------------------------------------------------------------
    # energy entry points
    # ------------------------------------------------------------------
    def compute_energy(self) -> float:
        p = self.problem()
        p.params = build_params(self.mesh)
        return float(jit_core.make_energy_value(p.spec)(p.state, p.topo, p.params))

    def compute_energy_and_gradient_array(self):
        p = self.problem()
        p.params = build_params(self.mesh)
        E, g = jit_core.make_energy_and_grad(p.spec)(p.state, p.topo, p.params)
        return float(E), np.asarray(g[: p.n_vertices])

    def tilt_relaxation_stats(self, max_iters: int | None = None) -> Dict[str, float]:
        """On-demand tilt-relaxation telemetry (reference
        TiltRelaxationManager.last_leaflet_relaxation_stats,
        tilt_relaxation.py:437-483).

        Runs one inner leaflet relaxation from the current state and reports
        its counters and energies.  Observability is pulled on demand instead
        of being threaded through the hot loop's carry — probing never
        perturbs the minimization trajectory (the reference documents
        observation-order hazards in its cached design; here the state is
        immutable so the probe is side-effect free by construction).
        """
        from membrane_solver_tpu.runtime import tilt_relax as _tr

        p = self.problem()
        p.params = build_params(self.mesh)
        if not _tr.spec_uses_leaflet_tilts(p.spec):
            return {"active": 0.0}
        relax = _tr.make_relax_leaflet_tilts(p.spec)
        gp = self.global_params
        iters = int(
            max_iters
            if max_iters is not None
            else gp.get("tilt_cg_max_iters", gp.get("tilt_inner_steps", 40)) or 40
        )
        step = float(gp.get("tilt_step_size", 0.1) or 0.1)
        tol = float(gp.get("tilt_tol", 0.0) or 0.0)
        _state, stats = relax(
            p.state,
            p.topo,
            p.params,
            jnp.asarray(iters, jnp.int32),
            jnp.asarray(step),
            jnp.asarray(tol),
        )
        return {
            "active": 1.0,
            "accepted_steps": float(stats.accepted_steps),
            "rejected": float(stats.rejected),
            "initial_energy": float(stats.initial_energy),
            "final_energy": float(stats.final_energy),
            "final_gradient_norm": float(stats.final_gradient_norm),
            "max_iters": float(iters),
            "tilt_step_size": step,
        }

    def relax_leaflet_tilts(
        self,
        max_iters: int | None = None,
        step_size: float | None = None,
        tol: float | None = None,
    ) -> Dict[str, float]:
        """Run one inner leaflet tilt relaxation and COMMIT the state.

        Parity: the reference's direct `_relax_leaflet_tilts` entry used by
        the flat-disk acceptance tools (positions frozen, coupled mode).
        """
        from membrane_solver_tpu.runtime import tilt_relax as _tr

        p = self.problem()
        p.params = build_params(self.mesh)
        if not _tr.spec_uses_leaflet_tilts(p.spec):
            return {"active": 0.0}
        gp = self.global_params
        iters = int(
            max_iters
            if max_iters is not None
            else gp.get("tilt_cg_max_iters", gp.get("tilt_inner_steps", 40)) or 40
        )
        step = float(
            step_size if step_size is not None else gp.get("tilt_step_size", 0.1) or 0.1
        )
        tol_v = float(tol if tol is not None else gp.get("tilt_tol", 0.0) or 0.0)
        relax = _tr.make_relax_leaflet_tilts(p.spec)
        p.state, stats = relax(
            p.state,
            p.topo,
            p.params,
            jnp.asarray(iters, jnp.int32),
            jnp.asarray(step),
            jnp.asarray(tol_v),
        )
        return {
            "active": 1.0,
            "accepted_steps": float(stats.accepted_steps),
            "final_energy": float(stats.final_energy),
            "final_gradient_norm": float(stats.final_gradient_norm),
        }

    def compute_energy_and_gradient(self):
        E, g = self.compute_energy_and_gradient_array()
        p = self.problem()
        grad = {int(vid): g[i] for i, vid in enumerate(p.vertex_ids)}
        # DEBUG monitor: projected gradient tangent to fixed-volume manifolds
        # (reference minimizer.py:1012 calls it on the same dict-gradient path)
        from membrane_solver_tpu.runtime.diagnostics.audit import (
            log_lagrange_tangency_check,
        )

        log_lagrange_tangency_check(self, grad)
        return E, grad

    def compute_energy_breakdown(self) -> Dict[str, float]:
        p = self.problem()
        p.params = build_params(self.mesh)
        from membrane_solver_tpu.device import geo as dgeo

        vals = jit_core.make_energy_breakdown(p.spec)(p.state, p.topo, p.params)
        return {k: float(v) for k, v in vals.items()}

    # ------------------------------------------------------------------
    # constraint enforcement
    # ------------------------------------------------------------------
    def enforce_constraints_after_mesh_ops(self, mesh: Mesh | None = None) -> None:
        """Hard geometric projection after topology surgery (strong context)."""
        if mesh is not None and mesh is not self.mesh:
            self.set_mesh(mesh)
        if not self._has_enforceable_constraints:
            return
        p = self.problem()
        enforce = jit_core.make_constraint_enforcer(p.spec)
        if enforce is not None:
            p.state = enforce(p.state, p.topo, p.params, context="mesh_operation")
            # position-dependent compiled payloads (e.g. the rim-matching
            # shell rings, whose membership keys on vertex radii) were
            # extracted from the PRE-projection positions; a refinement
            # midpoint lands on its pinned circle only after the geometric
            # projection above.  Recompile so the rings see the projected
            # geometry (the reference rebuilds its payload caches on every
            # version bump, constraint payload cache keys include
            # mesh._version).
            self._sync_host()
            self.invalidate()
            p = self.problem()
        # tilt-only constraints also re-enforce after topology surgery
        # (reference minimizer.enforce_constraints_after_mesh_ops)
        from membrane_solver_tpu.runtime import tilt_relax as _tr

        p.state = _tr.make_tilt_enforcer(p.spec)(p.state, p.topo, p.params)
        # tangent re-projection runs ON DEVICE: the former host-side
        # mesh.project_tilts_to_tangent() bumped the mesh version, forcing a
        # full host->device state recompile (O(N) Python entity loops) on
        # the next problem() — several seconds per minimize() call at
        # refined sizes.  The host copy is refreshed by writeback instead,
        # which mutates arrays in place without a version bump.
        p.state = self._project_tilts_device(p)
        self._sync_host()

    def _enforce_constraints(self, mesh: Mesh | None = None) -> None:
        if not self._has_enforceable_constraints:
            return
        p = self.problem()
        enforce = jit_core.make_constraint_enforcer(p.spec)
        if enforce is not None:
            p.state = enforce(p.state, p.topo, p.params, context="minimize")

    # ------------------------------------------------------------------
    # the outer loop
    # ------------------------------------------------------------------
    def minimize(
        self, n_steps: int = 1, callback: Optional[Callable[[Mesh, int], None]] = None
    ) -> dict:
        from membrane_solver_tpu.runtime.validation import (
            validate_disk_interface_topology,
            validate_gaussian_curvature_topology,
            validate_leaflet_absence_topology,
        )

        # topology validators read only host-side connectivity, which the
        # device never mutates — run once per topology epoch.  The token
        # holds the mesh object itself (not id(), which can be reused after
        # GC) plus the validation-relevant global parameters.
        gp_tok = tuple(
            (k, repr(self.global_params.get(k)))
            for k in sorted(self.global_params.to_dict())
            if "leaflet" in k or "disk" in k or "interface" in k or "gaussian" in k
        )
        raw_interval = self.global_params.get("tilt_projection_interval")
        if raw_interval is not None and int(raw_interval) < 1:
            raise ValueError("tilt_projection_interval must be >= 1.")
        tok = (self.mesh, getattr(self.mesh, "_topology_version", 0), gp_tok)
        if getattr(self, "_validated_topology_token", None) != tok:
            validate_leaflet_absence_topology(self.mesh, self.global_params)
            validate_disk_interface_topology(self.mesh, self.global_params)
            if "gaussian_curvature" in self.energy_module_names:
                validate_gaussian_curvature_topology(self.mesh, self.global_params)
            self._validated_topology_token = tok
        from membrane_solver_tpu.runtime.diagnostics.audit import check_gauss_bonnet

        if bool(self.global_params.get("gauss_bonnet_monitor", False)):
            self._sync_host()  # the monitor walks the host mesh
            check_gauss_bonnet(self)
        p = self.problem()
        p.params = build_params(self.mesh)

        if n_steps <= 0:
            E, grad = self.compute_energy_and_gradient()
            self._enforce_constraints()
            self._sync_host()
            return {
                "energy": float(self.compute_energy()),
                "gradient": grad,
                "mesh": self.mesh,
                "step_success": True,
                "iterations": 0,
                "terminated_early": True,
            }

        if self._has_enforceable_constraints:
            self.enforce_constraints_after_mesh_ops()
            p = self.problem()

        mode = str(self.global_params.get("volume_constraint_mode", "lagrange"))
        proj_flag = bool(self.global_params.get("volume_projection_during_minimization", True))
        has_volume_targets = any(
            (b.target_volume if b.target_volume is not None else b.options.get("target_volume"))
            is not None
            for b in self.mesh.bodies.values()
        )
        options = jit_core.MinimizeOptions(
            stepper=self.stepper.name,
            step_size_mode=str(self.global_params.get("step_size_mode", "adaptive") or "adaptive").lower(),
            enforce_in_line_search=self._has_enforceable_constraints,
            volume_drift_check=(
                mode == "lagrange"
                and not proj_flag
                and has_volume_targets
                and "volume" in self.constraint_module_names
            ),
        )
        block = jit_core.minimize_block(p.spec, options)
        if self._stepper_state is None:
            self._stepper_state = jit_core.fresh_stepper_state(p.spec.nv_cap, kind=self.stepper.name)

        repair_every = int(self.global_params.get("mesh_quality_auto_repair_every", 0) or 0)
        repair_enabled = bool(self.global_params.get("mesh_quality_auto_repair_enabled", False))

        fixed_step = float(self.global_params.get("step_size", self.step_size) or self.step_size)
        # Host-side module scalar updates (reference minimizer.py:1221
        # _update_scalar_params, called at the START of every iteration).
        # Only the opt-in legacy contact penalty actually moves a scalar
        # (energy/tilt_thetaB_contact_in.scalar_update_live); production
        # lanes keep the whole-chunk jitted fast path.
        scalar_hooks = [
            (name, m)
            for name, m in zip(self.energy_module_names, self.energy_modules)
            if hasattr(m, "update_scalar_params")
        ]
        thetaB_opt = bool(self.global_params.get("tilt_thetaB_optimize", False))
        scalar_hooks_live = any(
            not (thetaB_opt and name == "tilt_thetaB_contact_in")
            and getattr(m, "scalar_update_live", lambda *_a: True)(
                self.mesh, self.global_params
            )
            for name, m in scalar_hooks
        )
        zero_step_counter = 0
        iterations_done = 0
        step_success = True
        last_grad = None
        terminated = False
        converged = False

        while iterations_done < n_steps and not terminated:
            if callback is not None:
                self._sync_host()
                callback(self.mesh, iterations_done)

            if repair_enabled and repair_every > 0:
                until_repair = repair_every - (iterations_done % repair_every)
            else:
                until_repair = n_steps
            chunk = min(n_steps - iterations_done, until_repair)
            if not self.quiet:
                chunk = 1  # per-step reporting parity
            if scalar_hooks_live:
                # legacy closed-form theta_B update per iteration (reference
                # order: update -> relax -> scan -> step); reads host tilts,
                # so sync and step one iteration at a time.  The gp write is
                # a dynamic-only key: problem() refreshes params in place.
                chunk = 1
                self._sync_host()
                for name, m in scalar_hooks:
                    if thetaB_opt and name == "tilt_thetaB_contact_in":
                        continue  # reference minimizer.py:1121-1136
                    try:
                        m.update_scalar_params(
                            self.mesh, self.global_params, self.param_resolver
                        )
                    except TypeError:
                        m.update_scalar_params(self.mesh, self.global_params)
                p = self.problem()
                p.params = build_params(self.mesh)

            tilt_mode = str(self.global_params.get("tilt_solve_mode", "fixed") or "fixed")
            if tilt_mode == "nested":
                inner = int(self.global_params.get("tilt_inner_steps", 0) or 0)
            else:
                inner = int(
                    self.global_params.get(
                        "tilt_coupled_steps", self.global_params.get("tilt_inner_steps", 0)
                    )
                    or 0
                )
            if str(self.global_params.get("tilt_solver", "cg") or "cg").lower() == "cg":
                inner = int(self.global_params.get("tilt_cg_max_iters", inner) or inner)
            # theta_B scalar coordinate descent at its cadence boundaries.
            # Reference order WITHIN an iteration is relax -> scan -> step
            # (minimizer.py:1226 tilt solve, :1298 _optimize_thetaB_scalar,
            # :1360 stepper.step): the scan probes candidates from the
            # already-relaxed tilts and the accepted candidate's tilts feed
            # the shape step directly, with no re-relax in between.  So on
            # scan-due iterations run this iteration's guarded relax here,
            # then the scan, and tell the block to skip its first-iteration
            # relax.
            skip_first_relax = 0
            if bool(self.global_params.get("tilt_thetaB_optimize", False)):
                from membrane_solver_tpu.runtime import tilt_optimization as _topt
                from membrane_solver_tpu.runtime import tilt_relax as _tr

                if (
                    _topt.thetaB_scan_due(self, iterations_done)
                    and _tr.spec_uses_leaflet_tilts(p.spec)
                    and tilt_mode in {"nested", "coupled"}
                ):
                    grelax = jit_core.make_guarded_relax(p.spec)
                    p.params = build_params(self.mesh)
                    p.state = grelax(
                        p.state, p.topo, p.params, jnp.asarray(inner, jnp.int32)
                    )
                    skip_first_relax = 1
                _topt.optimize_thetaB_scalar(
                    self, tilt_mode=tilt_mode, iteration=iterations_done
                )
                p = self.problem()
                p.params = build_params(self.mesh)
                every = max(
                    int(self.global_params.get("tilt_thetaB_optimize_every", 10) or 10),
                    1,
                )
                chunk = min(chunk, every - (iterations_done % every))

            p.state, self._stepper_state, stats = block(
                p.state,
                p.topo,
                p.params,
                self._stepper_state,
                jnp.asarray(chunk, jnp.int32),
                jnp.asarray(self.step_size),
                jnp.asarray(fixed_step),
                jnp.asarray(self.tol),
                jnp.asarray(self.step_size_floor),
                jnp.asarray(self.max_zero_steps, jnp.int32),
                jnp.asarray(zero_step_counter, jnp.int32),
                jnp.asarray(inner, jnp.int32),
                jnp.asarray(skip_first_relax, jnp.int32),
            )
            done_now = int(stats.iterations)
            step_size_used = self.step_size
            iterations_done += done_now
            self.step_size = float(stats.step_size)
            zero_step_counter = int(stats.zero_step_counter)
            step_success = bool(stats.step_success)
            last_grad = float(stats.grad_norm)
            converged = bool(stats.converged)
            terminated = converged or bool(stats.terminated_early)

            if not self.quiet:
                self._sync_host()
                area = self.mesh.compute_total_surface_area()
                energy = self.compute_energy()
                print(
                    f"Step {iterations_done - 1:4d}: Area = {area:.5f}, "
                    f"Energy = {energy:.5f}, Step Size  = {step_size_used:.2e}"
                )

            if converged:
                logger.info(
                    "Converged in %d iterations; |gradE|=%.3e", iterations_done, last_grad
                )
                break
            if terminated:
                logger.info(
                    "Terminating early after %d consecutive zero-steps with step "
                    "size <= %.2e.",
                    zero_step_counter,
                    self.step_size_floor,
                )
                break

            # auto mesh-quality repair at the cadence boundary (host-side
            # equiangulation; reference runtime/mesh_quality_repair.py)
            if (
                repair_enabled
                and repair_every > 0
                and iterations_done < n_steps
                and iterations_done % repair_every == 0
            ):
                from membrane_solver_tpu.runtime.quality import maybe_auto_mesh_quality_repair

                if maybe_auto_mesh_quality_repair(self):
                    p = self.problem()
                    block = jit_core.minimize_block(p.spec, options)

        if self._has_enforceable_constraints:
            p = self.problem()
            enforce = jit_core.make_constraint_enforcer(p.spec)
            if enforce is not None:
                p.state = enforce(p.state, p.topo, p.params, context="finalize")

        p = self.problem()
        p.state = self._project_tilts_device(p)
        self._sync_host()
        final_energy = float(self.compute_energy())
        return {
            "energy": final_energy,
            "gradient": last_grad,
            "mesh": self.mesh,
            "step_success": step_success,
            "iterations": iterations_done,
            "terminated_early": terminated,
        }
