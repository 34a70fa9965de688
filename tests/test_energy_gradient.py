"""Energy/gradient assembly tests: analytic values + finite differences."""

import json
from pathlib import Path

import numpy as np
import pytest

from membrane_solver_tpu import Minimizer, load_data, parse_geometry

REF_CUBE = Path(__file__).resolve().parent.parent / "meshes" / "cube.json"


@pytest.fixture
def cube_minimizer():
    mesh = parse_geometry(load_data(REF_CUBE))
    return Minimizer(mesh, quiet=True)


def test_initial_energy_and_gradient_norm(cube_minimizer):
    # golden from the reference: E0 = 6.0, |grad| = sqrt(24)
    E, grad = cube_minimizer.compute_energy_and_gradient_array()
    assert E == pytest.approx(6.0, abs=1e-12)
    assert np.linalg.norm(grad) == pytest.approx(4.898979485566356, abs=1e-10)


def test_gradient_matches_finite_differences(cube_minimizer):
    minim = cube_minimizer
    E0, grad = minim.compute_energy_and_gradient_array()
    mesh = minim.mesh
    rng = np.random.default_rng(0)
    ids = minim.problem().vertex_ids
    h = 1e-6
    for _ in range(6):
        row = int(rng.integers(len(ids)))
        axis = int(rng.integers(3))
        vid = int(ids[row])
        orig = mesh.vertices[vid].position[axis]
        mesh.vertices[vid].position[axis] = orig + h
        minim.invalidate()
        Ep = minim.compute_energy()
        mesh.vertices[vid].position[axis] = orig - h
        minim.invalidate()
        Em = minim.compute_energy()
        mesh.vertices[vid].position[axis] = orig
        minim.invalidate()
        fd = (Ep - Em) / (2 * h)
        assert fd == pytest.approx(grad[row, axis], abs=1e-5)


def test_energy_breakdown_sums_to_total(cube_minimizer):
    breakdown = cube_minimizer.compute_energy_breakdown()
    assert set(breakdown) == {"surface", "volume"}
    assert sum(breakdown.values()) == pytest.approx(cube_minimizer.compute_energy(), rel=1e-14)
