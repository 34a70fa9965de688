"""Multi-chip parameter sweeps: vmapped minimization sharded over a device mesh.

The reference has no distributed execution (SURVEY §2.10); its only
embarrassingly-parallel axis is *parameter sweeps over mesh families* (disk
separations, theta_B scans, benchmark suites).  The JAX equivalent:
``vmap`` the jitted minimize block over a batch of problem members that share
one topology, and shard the batch axis over a ``jax.sharding.Mesh`` so members
run on separate chips with zero communication (pure data parallelism over the
sweep axis; collectives only at gather time).

Members may differ in initial positions/tilts, scalar parameters (moduli,
stiffnesses, theta_B candidates), per-entity parameter arrays, and step sizes
— anything that is a *dynamic* array in the compiled problem.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from membrane_solver_tpu.device.state import CompiledProblem, MeshState
from membrane_solver_tpu.runtime import jit_core

SWEEP_AXIS = "sweep"


@dataclasses.dataclass
class SweepBatch:
    """A batch of sweep members sharing one topology/spec."""

    problem: CompiledProblem  # the prototype (topology + spec)
    states: MeshState  # leading batch axis on every leaf
    params: Dict[str, Any]  # leading batch axis on every leaf
    n_members: int


def batch_problem(
    problem: CompiledProblem,
    member_params: Sequence[Dict[str, Any]],
    member_positions: Sequence[np.ndarray] | None = None,
) -> SweepBatch:
    """Stack sweep members from a prototype problem.

    ``member_params`` gives per-member overrides of scalar parameters; keys
    missing from a member fall back to the prototype's value.
    """
    n = len(member_params)

    def stack_state(leaf):
        return jnp.stack([leaf] * n, axis=0)

    states = jax.tree_util.tree_map(stack_state, problem.state)
    if member_positions is not None:
        pos = jnp.stack(
            [jnp.asarray(p, dtype=problem.state.positions.dtype) for p in member_positions]
        )
        states = dataclasses.replace(states, positions=pos)

    params: Dict[str, Any] = {}
    for key, proto_val in problem.params.items():
        vals = [m.get(key, proto_val) for m in member_params]
        params[key] = jnp.stack([jnp.asarray(v, dtype=jnp.asarray(proto_val).dtype) for v in vals])
    return SweepBatch(problem=problem, states=states, params=params, n_members=n)


def sweep_sharding(device_mesh: Mesh) -> NamedSharding:
    """Shard the leading (member) axis across the sweep mesh axis."""
    return NamedSharding(device_mesh, PartitionSpec(SWEEP_AXIS))


def make_sweep_minimize(
    spec,
    options: jit_core.MinimizeOptions,
    device_mesh: Mesh | None = None,
) -> Callable:
    """Jitted vmapped minimize: (SweepBatch fields) -> (batched states, stats).

    With a device mesh, batch-axis shardings are attached so XLA places one
    member group per chip (no cross-member collectives exist in the graph).
    """
    block = partial(jit_core._minimize_block_impl, spec, options)
    batched = jax.vmap(
        block,
        in_axes=(0, None, 0, 0, None, 0, None, None, None, None, 0),
    )

    def run(states, topo, params, stepper_states, n_steps, step_sizes, fixed_step,
            tol, floor, max_zero, zero_counters):
        return batched(
            states, topo, params, stepper_states, n_steps, step_sizes, fixed_step,
            tol, floor, max_zero, zero_counters,
        )

    from membrane_solver_tpu.utils.xla_cache import no_persistent_cache

    if device_mesh is None:
        # single-device: the persistent cache is safe (only MULTI-device
        # host executables hit the deserialization aborts)
        return jax.jit(run)
    shard = sweep_sharding(device_mesh)
    replicated = NamedSharding(device_mesh, PartitionSpec())

    def place(tree, sharding):
        return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)

    jitted = no_persistent_cache(jax.jit(run))

    def run_sharded(states, topo, params, stepper_states, n_steps, step_sizes,
                    fixed_step, tol, floor, max_zero, zero_counters):
        states = place(states, shard)
        params = place(params, shard)
        stepper_states = place(stepper_states, shard)
        step_sizes = jax.device_put(step_sizes, shard)
        zero_counters = jax.device_put(zero_counters, shard)
        topo = place(topo, replicated)
        return jitted(
            states, topo, params, stepper_states, n_steps, step_sizes, fixed_step,
            tol, floor, max_zero, zero_counters,
        )

    return run_sharded


def run_sweep(
    problem: CompiledProblem,
    member_params: Sequence[Dict[str, Any]],
    n_steps: int,
    step_size: float = 1e-3,
    options: jit_core.MinimizeOptions | None = None,
    device_mesh: Mesh | None = None,
    tol: float = 1e-6,
    member_positions: Sequence[np.ndarray] | None = None,
):
    """Convenience: batch, shard, minimize.

    Returns (batched states, batched stepper states, batched stats).
    """
    options = options or jit_core.MinimizeOptions()
    batch = batch_problem(problem, member_params, member_positions=member_positions)
    run = make_sweep_minimize(problem.spec, options, device_mesh)
    n = batch.n_members
    stepper_states = jax.vmap(lambda _: jit_core.fresh_stepper_state(problem.spec.nv_cap, kind=options.stepper))(
        jnp.arange(n)
    )
    return run(
        batch.states,
        problem.topo,
        batch.params,
        stepper_states,
        jnp.asarray(n_steps, jnp.int32),
        jnp.full((n,), step_size),
        jnp.asarray(step_size),
        jnp.asarray(tol),
        jnp.asarray(1e-8),
        jnp.asarray(10, jnp.int32),
        jnp.zeros((n,), jnp.int32),
    )
