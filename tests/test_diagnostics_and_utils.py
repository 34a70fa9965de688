"""Unit tests for side-rail modules: ordered_set and diagnostics (audit,
patches).

Parity: reference tests cover these surfaces via test_caching.py /
test_gauss_bonnet.py / diagnostics usage in the minimizer; here each module
gets a direct lane.
"""

from __future__ import annotations

import logging

import numpy as np


# ---------------------------------------------------------------- ordered_set
def test_ordered_unique_list_dedupes_preserving_order():
    from membrane_solver_tpu.core.ordered_set import OrderedUniqueList

    lst = OrderedUniqueList(["surface", "volume", "surface"])
    assert list(lst) == ["surface", "volume"]
    lst.append("volume")
    lst.add("bending")
    lst.extend(["surface", "tilt"])
    assert list(lst) == ["surface", "volume", "bending", "tilt"]
    lst += ["tilt", "line_tension"]
    assert list(lst) == ["surface", "volume", "bending", "tilt", "line_tension"]
    cp = lst.copy()
    assert isinstance(cp, OrderedUniqueList) and list(cp) == list(lst)
    cp.append("surface")
    assert len(cp) == len(lst)


# ------------------------------------------------------------------- patches
def _two_patch_disk(n_ring=8):
    from membrane_solver_tpu.geometry.entities import Edge, Facet, Vertex
    from membrane_solver_tpu.geometry.mesh import Mesh

    mesh = Mesh()
    mesh.vertices[1] = Vertex(1, np.array([0.0, 0.0, 0.0]))
    for i in range(n_ring):
        ang = 2 * np.pi * i / n_ring
        mesh.vertices[2 + i] = Vertex(2 + i, np.array([np.cos(ang), np.sin(ang), 0.0]))
    eid = 1
    spokes, ring = {}, {}
    for i in range(n_ring):
        spokes[i] = eid
        mesh.edges[eid] = Edge(eid, 1, 2 + i)
        eid += 1
    for i in range(n_ring):
        ring[i] = eid
        mesh.edges[eid] = Edge(eid, 2 + i, 2 + (i + 1) % n_ring)
        eid += 1
    for i in range(n_ring):
        fid = 1 + i
        mesh.facets[fid] = Facet(fid, [spokes[i], ring[i], -spokes[(i + 1) % n_ring]])
        mesh.facets[fid].options["disk_patch"] = "A" if i < n_ring // 2 else "B"
    return mesh


def test_patch_boundary_edges_between_labels():
    from membrane_solver_tpu.runtime.diagnostics.patches import (
        patch_boundary_edges,
        patch_boundary_lengths,
    )

    mesh = _two_patch_disk()
    grouped = patch_boundary_edges(mesh)
    # A|B transitions happen at exactly two spokes (i=0 and i=4 boundaries);
    # each interface edge is listed under BOTH labels
    assert set(grouped) == {"A", "B"}
    ids_a = sorted(e.index for e in grouped["A"])
    ids_b = sorted(e.index for e in grouped["B"])
    assert ids_a == ids_b and len(ids_a) == 2
    lengths = patch_boundary_lengths(mesh)
    # spokes are radius-1 segments
    assert abs(lengths["A"] - 2.0) < 1e-12
    assert abs(lengths["B"] - 2.0) < 1e-12


def test_patch_boundary_includes_mesh_boundary_when_asked():
    from membrane_solver_tpu.runtime.diagnostics.patches import patch_boundary_edges

    mesh = _two_patch_disk()
    grouped = patch_boundary_edges(mesh, include_mesh_boundary=True)
    # ring edges are single-facet boundary edges: 4 per label + 2 spokes
    assert len(grouped["A"]) == 6
    assert len(grouped["B"]) == 6


def test_patch_boundary_respects_patch_values_filter():
    from membrane_solver_tpu.runtime.diagnostics.patches import patch_boundary_edges

    mesh = _two_patch_disk()
    grouped = patch_boundary_edges(mesh, patch_values=["A"])
    # with only A allowed, B facets count as unlabeled; the A/B spokes are
    # still label-vs-None boundaries reported under A
    assert set(grouped) == {"A"}
    assert len(grouped["A"]) == 2


# --------------------------------------------------------------------- audit
def _cube_minimizer():
    from membrane_solver_tpu import Minimizer, load_data, parse_geometry

    mesh = parse_geometry(load_data("meshes/cube.json"))
    mesh.instructions = []
    return Minimizer(mesh, quiet=True)


def test_audit_logging_helpers_run_at_debug(caplog):
    from membrane_solver_tpu.runtime.diagnostics import audit

    mn = _cube_minimizer()
    with caplog.at_level(logging.DEBUG, logger="membrane_solver_tpu"):
        audit.log_energy_phase(0, "entry", 1.25)
        audit.log_step_direction_stats(0, np.ones((4, 3)))
        audit.log_energy_consistency(mn, "unit")
    text = caplog.text
    assert "E[0:entry]" in text
    assert "grad[0]" in text
    # single jitted assembly: consistency must agree (no mismatch warning)
    assert "Energy consistency mismatch" not in text
    assert "Energy consistency (unit)" in text


def test_audit_check_gauss_bonnet_attaches_monitor():
    from membrane_solver_tpu.runtime.diagnostics import audit

    mn = _cube_minimizer()
    mn.global_params.update({"gauss_bonnet_monitor": True})
    audit.check_gauss_bonnet(mn)
    monitor = getattr(mn, "_gauss_bonnet_monitor", None)
    assert monitor is not None
    report = monitor.evaluate(mn.mesh)
    assert report["ok"]  # no drift without any minimization


def test_audit_gauss_bonnet_off_by_default():
    from membrane_solver_tpu.runtime.diagnostics import audit

    mn = _cube_minimizer()
    audit.check_gauss_bonnet(mn)
    assert getattr(mn, "_gauss_bonnet_monitor", None) is None
