"""Tensor-parallel (vertex-sharded) energy/gradient evaluation.

The reference has no model parallelism (SURVEY 2.10); its analog of
"the model outgrowing one device" is mesh growth under refinement.  The
JAX answer: shard the capacity-padded vertex/triangle axes of the
compiled problem across a ``jax.sharding.Mesh`` axis ("tp") with
``NamedSharding`` annotations and let XLA insert the collectives — the
corner gathers become all-gathers of the (small) position array, the
vertex scatter-adds become reduce-scatters over the segment sums.  This
is the scaling-book recipe (annotate, compile, let XLA place
collectives), not hand-written ring passes: at membrane sizes the
position array is tiny relative to the per-triangle work, so the
all-gather is firmly bandwidth-trivial and the per-triangle FLOPs
(the dominant term) split ``1/n_devices`` per chip.

Use:

    mesh = tp_mesh(8)                      # or your own Mesh with a "tp" axis
    state, topo = shard_problem(p, mesh)   # device-put with tp shardings
    E, g = tp_energy_and_grad(p.spec, mesh)(state, topo, p.params)
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from membrane_solver_tpu.runtime import jit_core

TP_AXIS = "tp"


def tp_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (TP_AXIS,))


def _state_shardings(mesh: Mesh):
    """Vertex-major leaves shard on the vertex axis."""
    row = NamedSharding(mesh, P(TP_AXIS, None))
    return row


def shard_problem(problem, mesh: Mesh):
    """Device-put the problem's state and topology with tp shardings.

    Vertex-indexed arrays shard along the (power-of-two, hence divisible)
    capacity axis; triangle/edge arrays shard along their own leading axis;
    small per-body arrays and extras replicate.
    """
    row = NamedSharding(mesh, P(TP_AXIS))
    row2 = NamedSharding(mesh, P(TP_AXIS, None))
    rep = NamedSharding(mesh, P())

    def put(leaf, sharding):
        return jax.device_put(leaf, sharding)

    state = problem.state
    state = type(state)(
        positions=put(state.positions, row2),
        tilts=put(state.tilts, row2),
        tilts_in=put(state.tilts_in, row2),
        tilts_out=put(state.tilts_out, row2),
    )
    topo = problem.topo
    import dataclasses

    n_dev = mesh.devices.size

    def vec_sharding(arr):
        # shard leading axis when divisible; replicate otherwise (extras
        # with ring-sized or scalar shapes)
        if hasattr(arr, "ndim") and arr.ndim >= 1 and arr.shape[0] % n_dev == 0:
            return row2 if arr.ndim > 1 else row
        return rep

    topo = dataclasses.replace(
        topo,
        tri_rows=put(topo.tri_rows, vec_sharding(topo.tri_rows)),
        tri_valid=put(topo.tri_valid, vec_sharding(topo.tri_valid)),
        tri_surface_tension=put(topo.tri_surface_tension, vec_sharding(topo.tri_surface_tension)),
        tri_body=put(topo.tri_body, vec_sharding(topo.tri_body)),
        edge_rows=put(topo.edge_rows, vec_sharding(topo.edge_rows)),
        edge_valid=put(topo.edge_valid, vec_sharding(topo.edge_valid)),
        vertex_valid=put(topo.vertex_valid, row),
        boundary_vertex_mask=put(topo.boundary_vertex_mask, row),
        fixed_mask=put(topo.fixed_mask, row),
        tilt_fixed_mask=put(topo.tilt_fixed_mask, row),
        tilt_fixed_in_mask=put(topo.tilt_fixed_in_mask, row),
        tilt_fixed_out_mask=put(topo.tilt_fixed_out_mask, row),
        body_valid=put(topo.body_valid, rep),
        body_target_volume=put(topo.body_target_volume, rep),
        body_has_target=put(topo.body_has_target, rep),
        body_volume_stiffness=put(topo.body_volume_stiffness, rep),
        extras={k: put(v, vec_sharding(v)) for k, v in topo.extras.items()},
    )
    return state, topo


def tp_energy_and_grad(spec, mesh: Mesh) -> Callable:
    """Jitted (E, grad) whose outputs keep the tp sharding.

    XLA partitions the whole graph from the input shardings: per-triangle
    geometry runs sharded on the triangle axis, corner gathers all-gather
    the position shards over ICI, and the vertex scatter-add lowers to a
    reduce-scatter back to the vertex sharding.
    """
    vg = jit_core.make_energy_vg(spec)

    @jax.jit
    def run(state, topo, params):
        E, g = vg(state.positions, state, topo, params)
        return E, g

    from membrane_solver_tpu.utils.xla_cache import no_persistent_cache

    return no_persistent_cache(run)


def tp_minimize_block(spec, options, mesh: Mesh) -> Callable:
    """The full jitted minimize block, executable on tp-sharded inputs.

    Wrapped to bypass the persistent compilation cache: deserializing the
    multi-device host-platform executable aborts (utils/xla_cache.py).
    """
    from membrane_solver_tpu.utils.xla_cache import no_persistent_cache

    return no_persistent_cache(jit_core.minimize_block(spec, options))
