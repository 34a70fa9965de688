"""Frozen tilt energy pair (runtime/tilt_relax.make_frozen_energy_pair).

The inner tilt CG evaluates the tilt-dependent energy through the frozen
program: position-only fields computed once, then the per-module sums.
Its value and AD gradient must match the full per-evaluation tilt energy
(runtime/tilt_relax.make_tilt_energy), which recomputes the geometry on
every call, on the kozlov 1-disk lane at two refinement levels (336 and
1,344 triangles, neither a multiple of a power-of-two block) and in both
float dtypes.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from membrane_solver_tpu.runtime import tilt_relax as tr

RTOL = {jnp.float64: 1e-12, jnp.float32: 2e-5}


@functools.lru_cache(maxsize=None)
def _problem(refines, dtype):
    from membrane_solver_tpu import Minimizer, parse_geometry
    from membrane_solver_tpu.device.state import build_params
    from membrane_solver_tpu.meshgen import build
    from membrane_solver_tpu.runtime.refinement import (
        refine_polygonal_facets,
        refine_triangle_mesh,
    )

    mesh = parse_geometry(build("kozlov_1disk"))
    mesh.global_parameters.update(
        {"tilt_solve_mode": "coupled", "tilt_step_size": 0.15, "tilt_tol": 0.0}
    )
    mn = Minimizer(mesh, quiet=True)
    for _ in range(refines):
        mn.mesh = refine_triangle_mesh(refine_polygonal_facets(mn.mesh))
        mn.invalidate()
        mn.enforce_constraints_after_mesh_ops()
    p = mn.problem()
    params = {
        k: jnp.asarray(v, dtype) if jnp.issubdtype(jnp.asarray(v).dtype, jnp.floating) else v
        for k, v in build_params(mn.mesh).items()
    }
    state = dataclasses.replace(
        p.state,
        positions=p.state.positions.astype(dtype),
        tilts_in=p.state.tilts_in.astype(dtype),
        tilts_out=p.state.tilts_out.astype(dtype),
        tilts=p.state.tilts.astype(dtype),
    )
    prog = tr.collect_frozen_tilt_program(p.spec)
    assert prog is not None
    pair = jax.jit(
        jax.value_and_grad(tr.make_frozen_energy_pair(prog, state, p.topo, params), argnums=(0, 1))
    )
    full_energy = tr.make_tilt_energy(p.spec)

    def full(tin, tout):
        st = dataclasses.replace(state, tilts_in=tin, tilts_out=tout)
        return full_energy(st, p.topo, params)

    full = jax.jit(jax.value_and_grad(full, argnums=(0, 1)))
    return state, int(p.topo.tri_valid.sum()), pair, full


def _tilts(state, scale, seed):
    if scale == 0.0:
        return state.tilts_in, state.tilts_out
    rng = np.random.default_rng(seed)
    dtype = state.positions.dtype
    return tuple(
        jnp.asarray(scale * rng.standard_normal(state.tilts_in.shape), dtype) for _ in range(2)
    )


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("scale", [0.0, 0.1], ids=["state", "random"])
@pytest.mark.parametrize("refines,n_tri", [(0, 336), (1, 1344)])
def test_frozen_pair_energy_matches_full(refines, n_tri, scale, dtype):
    state, valid, pair, full = _problem(refines, dtype)
    assert valid == n_tri
    tilts = _tilts(state, scale, seed=refines)
    (e_frozen, _), (e_full, _) = pair(*tilts), full(*tilts)
    assert e_frozen.dtype == dtype
    assert float(e_frozen) == pytest.approx(float(e_full), rel=RTOL[dtype])


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("refines", [0, 1])
def test_frozen_pair_gradient_matches_full(refines, dtype):
    state, _, pair, full = _problem(refines, dtype)
    tilts = _tilts(state, 0.1, seed=7 + refines)
    (_, g_frozen), (_, g_full) = pair(*tilts), full(*tilts)
    # one scale for both leaflets: a leaflet with little energy of its own
    # has a gradient near roundoff, which no scale of its own can judge
    scale = max(float(jnp.max(jnp.abs(b))) for b in g_full)
    for a, b in zip(g_frozen, g_full):
        assert a.shape == b.shape == state.tilts_in.shape
        assert float(jnp.max(jnp.abs(a - b))) <= 10 * RTOL[dtype] * scale


@pytest.mark.parametrize("refines", [0, 1])
def test_frozen_pair_is_quadratic_in_tilt(refines):
    """At fixed geometry the tilt energy is quadratic in the tilts, so its
    even part Q(t) = (E(t) + E(-t)) / 2 - E(0) scales as Q(2t) = 4 Q(t)."""
    state, _, pair, _ = _problem(refines, jnp.float64)
    tin, tout = _tilts(state, 0.1, seed=11)
    zero = jnp.zeros_like(tin)
    e0 = float(pair(zero, zero)[0])

    def q(s):
        return 0.5 * (float(pair(s * tin, s * tout)[0]) + float(pair(-s * tin, -s * tout)[0])) - e0

    assert q(2.0) == pytest.approx(4.0 * q(1.0), rel=1e-10)
