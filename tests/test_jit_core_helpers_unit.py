"""Direct unit lanes for small jit_core / state / utils helpers.

Analytic expectations on hand-built inputs: the local-projection
Gram-Schmidt channel, tangent hygiene for all tilt fields, capacity
padding, the persistent-cache guard, the
edge-cycle orientation quirk, and the smoothness transport kernels.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from membrane_solver_tpu import Minimizer, parse_geometry
from membrane_solver_tpu.device.state import capacity_for
from membrane_solver_tpu.energy.tilt_smoothness import minimal_rotation, smoothness_energy
from membrane_solver_tpu.geometry.mesh import orient_edges_cycle
from membrane_solver_tpu.meshgen import build
from membrane_solver_tpu.runtime import jit_core
from membrane_solver_tpu.utils import xla_cache


# ------------------------------------------------------------- capacity_for
def test_capacity_for_powers_of_two_with_minimum():
    assert capacity_for(0) == 8
    assert capacity_for(8) == 8
    assert capacity_for(9) == 16
    assert capacity_for(16) == 16
    assert capacity_for(1000) == 1024
    assert capacity_for(3, minimum=4) == 4


# ---------------------------------------------- local projection primitives
def test_orthonormalize_local_normals_spans_and_collapses():
    # vertex 0: two independent normals; vertex 1: near-parallel duplicate;
    # vertex 2: all-zero rows (unconstrained)
    normals = jnp.asarray(
        [
            [[1.0, 0.0, 0.0], [1.0, 1.0, 0.0]],
            [[0.0, 1.0, 0.0], [0.0, 1.0, 1e-15]],
            [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
        ]
    )
    q = np.asarray(jit_core.orthonormalize_local_normals(normals))
    # vertex 0: orthonormal pair spanning the xy-plane
    assert np.allclose(q[0, 0], [1.0, 0.0, 0.0])
    assert np.allclose(np.abs(q[0, 1]), [0.0, 1.0, 0.0], atol=1e-12)
    assert np.isclose(q[0, 0] @ q[0, 1], 0.0, atol=1e-12)
    # vertex 1: the duplicate collapses to an exact zero row
    assert np.allclose(q[1, 0], [0.0, 1.0, 0.0])
    assert np.allclose(q[1, 1], 0.0)
    # vertex 2: zero stays zero
    assert np.allclose(q[2], 0.0)


def test_apply_local_projection_removes_constrained_components():
    normals = jit_core.orthonormalize_local_normals(
        jnp.asarray([[[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]]])
    )
    vec = jnp.asarray([[3.0, -2.0, 5.0]])
    out = np.asarray(jit_core.apply_local_projection(vec, normals))
    assert np.allclose(out, [[3.0, 0.0, 0.0]], atol=1e-12)


def test_project_all_tilts_makes_every_field_tangent():
    mn = Minimizer(parse_geometry(build("square_sheet")), quiet=True)
    p = mn.problem()
    import dataclasses

    rng = np.random.default_rng(3)
    noisy = dataclasses.replace(
        p.state,
        tilts=jnp.asarray(rng.normal(size=p.state.tilts.shape)),
        tilts_in=jnp.asarray(rng.normal(size=p.state.tilts.shape)),
        tilts_out=jnp.asarray(rng.normal(size=p.state.tilts.shape)),
    )
    out = jit_core.project_all_tilts(noisy, p.topo)
    from membrane_solver_tpu.device import geo as dgeo

    geo = dgeo.triangle_geometry(out.positions, p.topo.tri_rows, p.topo.tri_valid)
    nrm = dgeo.vertex_normals(geo, p.topo.tri_rows, p.topo.tri_valid, out.positions.shape[0])
    for field in (out.tilts, out.tilts_in, out.tilts_out):
        dots = np.asarray(jnp.sum(field * nrm, axis=1))
        assert np.allclose(dots, 0.0, atol=1e-12)


def test_make_energy_of_positions_matches_total_energy():
    mn = Minimizer(parse_geometry(build("cube")), quiet=True)
    p = mn.problem()
    total = jit_core.make_total_energy(p.spec)
    of_pos = jit_core.make_energy_of_positions(p.spec)
    e0 = float(total(p.state, p.topo, p.params))
    assert float(of_pos(p.state.positions, p.state, p.topo, p.params)) == e0
    moved = p.state.positions * 1.01
    e1 = float(of_pos(moved, p.state, p.topo, p.params))
    assert e1 != e0  # positions argument is live, not the state copy


# ------------------------------------------------------ persistent cache guard
def test_no_persistent_cache_disables_and_restores():
    prev = jax.config.jax_compilation_cache_dir

    @xla_cache.no_persistent_cache
    def inside():
        return jax.config.jax_compilation_cache_dir

    assert inside() is None
    assert jax.config.jax_compilation_cache_dir == prev


# -------------------------------------------------------- edge-cycle quirk
def test_orient_edges_cycle_chains_and_forces_first_positive():
    mesh = parse_geometry(build("cube"))
    # triangulate so facets have 3+ edges in a cycle
    from membrane_solver_tpu.runtime.refinement import refine_polygonal_facets

    mesh = refine_polygonal_facets(mesh)
    facet = next(iter(mesh.facets.values()))
    signed = list(facet.edge_indices)
    # feed the cycle with the first edge NEGATED: the quirk forces it positive
    shuffled = [-abs(signed[0])] + signed[1:]
    cycle = orient_edges_cycle(shuffled, mesh)
    assert cycle[0] == abs(signed[0]) > 0
    # continuity: each edge's head is the next edge's tail
    heads = [mesh.get_edge(e).endpoints(e)[1] for e in cycle]
    tails = [mesh.get_edge(e).endpoints(e)[0] for e in cycle]
    assert all(heads[i] == tails[(i + 1) % len(cycle)] for i in range(len(cycle)))


# -------------------------------------------------- smoothness transports
def test_minimal_rotation_identity_and_norm_preserving():
    a = jnp.asarray([[0.0, 0.0, 1.0]])
    b = jnp.asarray([[0.0, 1.0, 0.0]])
    t = jnp.asarray([[0.3, -0.4, 0.0]])
    same = minimal_rotation(t, a, a)
    assert np.allclose(np.asarray(same), np.asarray(t), atol=1e-12)
    rot = np.asarray(minimal_rotation(t, a, b))
    assert np.isclose(np.linalg.norm(rot), np.linalg.norm(np.asarray(t)), atol=1e-12)


@pytest.mark.parametrize("transport", ["ambient_v1", "connection_v1"])
def test_smoothness_energy_zero_for_uniform_tilt_on_flat_sheet(transport):
    """A constant in-plane tilt field on a flat mesh has zero Dirichlet
    smoothness energy under both transport models."""
    mn = Minimizer(parse_geometry(build("square_sheet")), quiet=True)
    p = mn.problem()
    tilts = jnp.zeros_like(p.state.tilts).at[:, 0].set(0.7)
    e = smoothness_energy(p.state.positions, tilts, p.topo, 1.0, transport)
    assert float(e) == pytest.approx(0.0, abs=1e-20)
    # a non-uniform field must cost energy (the kernel is not trivially zero)
    rng = np.random.default_rng(11)
    noisy = jnp.asarray(rng.normal(size=p.state.tilts.shape))
    noisy = noisy.at[:, 2].set(0.0)
    e2 = smoothness_energy(p.state.positions, noisy, p.topo, 1.0, transport)
    assert float(e2) > 1e-6
