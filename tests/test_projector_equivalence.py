"""Three-channel KKT projector == full dense row stack.

make_gradient_projector splits constraint rows into local per-vertex
projectors, compact slot rows, and dense rows; this must produce the same
projection as stacking every module's dense rows into one KKT solve
(make_constraint_gradients + project_gradient_kkt), which is the
reference's formulation.  Checked on the kozlov lane (pins -> local, rim
-> compact) and the cap lane (volume -> dense, pins -> local).
"""

from __future__ import annotations

import numpy as np
import pytest

from membrane_solver_tpu import Minimizer, parse_geometry
from membrane_solver_tpu.meshgen import build
from membrane_solver_tpu.runtime import jit_core


def _compare(problem, seed=0, tol=1e-9):
    p = problem
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(np.asarray(p.state.positions).shape)
    g[~np.asarray(p.topo.vertex_valid)] = 0.0
    import jax.numpy as jnp

    g = jnp.asarray(g)

    project = jit_core.make_gradient_projector(p.spec)
    assert project is not None
    fast = np.asarray(project(g, p.state, p.topo, p.params))

    # ground truth: SVD-based orthogonal projection onto null(R) of the FULL
    # dense row stack.  (The duplicated rows that pins produce — plane row ==
    # circle plane row — make the regularized normal-equation solve itself
    # numerically fragile; the SVD projection is the clean formulation.)
    rows = jit_core.make_constraint_gradients(p.spec)(p.state, p.topo, p.params)
    assert rows is not None
    R = np.asarray(rows).reshape(rows.shape[0], -1)
    U, s, Vt = np.linalg.svd(R, full_matrices=False)
    rank = int(np.sum(s > 1e-10 * max(s.max(), 1e-30)))
    V = Vt[:rank]
    gflat = np.asarray(g).reshape(-1)
    dense = (gflat - V.T @ (V @ gflat)).reshape(fast.shape)

    scale = max(float(np.abs(dense).max()), 1.0)
    np.testing.assert_allclose(fast, dense, atol=tol * scale, rtol=0)

    # the projected gradient must annihilate every constraint row
    resid = R @ fast.reshape(-1)
    live = np.abs(R).sum(axis=1) > 0
    assert np.abs(resid[live]).max() < 1e-8 * scale


def test_kozlov_lane_projector_equivalence():
    mesh = parse_geometry(build("kozlov_1disk"))
    p = Minimizer(mesh, quiet=True).problem()
    _compare(p)


def test_cap_lane_projector_equivalence():
    mesh = parse_geometry(build("spherical_cap"))
    p = Minimizer(mesh, quiet=True).problem()
    _compare(p)


def _compare_tilt_projectors(p, expect_background):
    import jax.numpy as jnp

    from membrane_solver_tpu.runtime import tilt_relax

    collector = tilt_relax.make_compact_tilt_collector(p.spec)
    assert collector is not None, "lane must be compact-representable"
    compact = collector(p.state, p.topo, p.params)
    assert compact is not None
    if expect_background:
        assert compact[3], "shared-disk lane must carry a rank-1 background"
    project_fast = tilt_relax.make_compact_tilt_projector(compact)

    rows = tilt_relax.make_tilt_constraint_rows(p.spec)(p.state, p.topo, p.params)
    assert rows is not None
    project_dense = tilt_relax.make_tilt_projector(rows)

    rng = np.random.default_rng(3)
    shape = np.asarray(p.state.tilts_in).shape
    gin = jnp.asarray(rng.standard_normal(shape))
    gout = jnp.asarray(rng.standard_normal(shape))
    fi, fo = project_fast(gin, gout)
    di, do = project_dense(gin, gout)
    scale = max(float(np.abs(np.asarray(di)).max()), 1.0)
    np.testing.assert_allclose(np.asarray(fi), np.asarray(di), atol=1e-9 * scale, rtol=0)
    np.testing.assert_allclose(np.asarray(fo), np.asarray(do), atol=1e-9 * scale, rtol=0)

    # and the projected gradient annihilates every dense row
    R = np.asarray(rows).reshape(rows.shape[0], -1)
    g = np.concatenate([np.asarray(fi).ravel(), np.asarray(fo).ravel()])
    live = np.abs(R).sum(axis=1) > 0
    assert np.abs((R @ g)[live]).max() < 1e-8 * scale


def test_kozlov_tilt_projector_compact_vs_dense():
    """Standard lane: local 1:1 disk pairing (slot rows only)."""
    mesh = parse_geometry(build("kozlov_1disk"))
    p = Minimizer(mesh, quiet=True).problem()
    from membrane_solver_tpu.constraints import rim_slope_match_out as rim

    assert rim._spec_flags(p.spec) is not None, "rim matching must be active"
    _compare_tilt_projectors(p, expect_background=False)


def test_kozlov_shared_disk_tilt_projector_compact_vs_dense():
    """Shared-mean-field mode (disk ring size != rim ring size): in rows
    carry the rank-1 disk-mean background; the compact projector must still
    match the dense O(k*Nv) row stack it replaces."""
    data = build("kozlov_1disk")
    # tag the second interior disk ring into the disk group too, breaking
    # the 1:1 rim pairing -> shared-mean-field coupling
    n_tagged = 0
    for v in data["vertices"]:
        if isinstance(v[-1], dict) and v[-1].get("preset") == "disk":
            if "rim_slope_match_group" not in v[-1]:
                v[-1]["rim_slope_match_group"] = "disk"
                n_tagged += 1
                if n_tagged >= 8:
                    break
    assert n_tagged == 8
    mesh = parse_geometry(data)
    p = Minimizer(mesh, quiet=True).problem()
    from membrane_solver_tpu.constraints import rim_slope_match_out as rim

    flags = rim._spec_flags(p.spec)  # (has_disk, interp_outer, local_disk, theta_is_param)
    assert flags is not None and flags[0] and not flags[2], (
        "variant must be in the shared (non-local) disk mode"
    )
    _compare_tilt_projectors(p, expect_background=True)


def test_mixed_compact_and_dense_channels():
    """A lane with rim matching (compact) AND a volume body (dense)."""
    data = build("kozlov_1disk")
    nf = len(data["faces"])
    data["bodies"] = {"faces": [list(range(nf))], "target_volume": [0.3]}
    data["constraint_modules"] = list(data["constraint_modules"]) + ["volume"]
    data["global_parameters"]["volume_constraint_mode"] = "lagrange"
    mesh = parse_geometry(data)
    p = Minimizer(mesh, quiet=True).problem()
    _compare(p)
