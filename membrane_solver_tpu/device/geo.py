"""Pure-JAX mesh geometry kernels over padded SoA arrays.

These are the JAX equivalents of the reference's vectorized NumPy /
f2py-Fortran geometry kernels:

- triangle normals/areas                (reference geometry/triangle_ops.py:8-40)
- barycentric vertex areas              (geometry/triangle_ops.py:43-60)
- vertex unit normals                   (geometry/triangle_ops.py:63-80)
- P1 shape gradients g_i = (n x e_i)/|n|^2   (geometry/triangle_ops.py:83-95,
                                              fortran_kernels/tilt_kernels.f90:26-86)
- cotan curvature data (integrated mean-curvature vectors K_i, Meyer
  mixed-Voronoi vertex areas with obtuse branches, per-corner cotan weights)
                                        (geometry/curvature.py:113-332,
                                         fortran_kernels/tilt_kernels.f90:88-190)
- angle defects (integrated Gaussian curvature, boundary rows zeroed)
                                        (geometry/curvature.py:335-400)

All functions are shape-polymorphic only in the padded capacity; invalid rows
are masked so padding contributes exactly zero.  Scatter-adds use
``.at[].add``, the same accumulation as the reference's ``np.add.at``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax

import jax.numpy as jnp

from membrane_solver_tpu.utils.precision import tiny as _tiny

EPS_AREA = 1e-12


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def safe_norm(vecs: jnp.ndarray, eps: float = EPS_AREA) -> jnp.ndarray:
    """Row norms that are AD-safe at zero (padded rows).

    ``jnp.linalg.norm`` has a NaN gradient at 0; masking with ``where`` after
    the fact does not stop NaN propagation through the untaken branch, so the
    guard must be inside the sqrt (double-where trick).  Rows with norm below
    ``eps`` return exactly 0 with zero gradient.
    """
    sq = jnp.sum(vecs * vecs, axis=-1)
    good = sq > (eps * eps)
    return jnp.where(good, jnp.sqrt(jnp.where(good, sq, 1.0)), 0.0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TriangleGeometry:
    """Per-evaluation shared geometry (the reference's EnergyContext analog)."""

    v0: jnp.ndarray  # (F, 3) gathered corner positions
    v1: jnp.ndarray
    v2: jnp.ndarray
    normal: jnp.ndarray  # (F, 3) unnormalized (doubled-area) normals
    double_area: jnp.ndarray  # (F,) |normal| (>= EPS floor on valid rows)
    area: jnp.ndarray  # (F,) masked triangle areas (0 on invalid rows)
    unit_normal: jnp.ndarray  # (F, 3) zero on degenerate/invalid rows


def triangle_geometry(
    positions: jnp.ndarray, tri_rows: jnp.ndarray, tri_valid: jnp.ndarray
) -> TriangleGeometry:
    v0 = positions[tri_rows[:, 0]]
    v1 = positions[tri_rows[:, 1]]
    v2 = positions[tri_rows[:, 2]]
    n = jnp.cross(v1 - v0, v2 - v0)
    dbl = safe_norm(n)
    ok = tri_valid & (dbl >= EPS_AREA)
    unit = jnp.where(ok[:, None], n / jnp.maximum(dbl, EPS_AREA)[:, None], 0.0)
    area = jnp.where(ok, 0.5 * dbl, 0.0)
    return TriangleGeometry(
        v0=v0, v1=v1, v2=v2, normal=n, double_area=dbl, area=area, unit_normal=unit
    )


def scatter_add_rows(
    values0: jnp.ndarray,
    values1: jnp.ndarray,
    values2: jnp.ndarray,
    tri_rows: jnp.ndarray,
    n_rows: int,
) -> jnp.ndarray:
    """Scatter three per-triangle corner value arrays into per-vertex rows."""
    out = jnp.zeros((n_rows,) + values0.shape[1:], dtype=values0.dtype)
    out = out.at[tri_rows[:, 0]].add(values0)
    out = out.at[tri_rows[:, 1]].add(values1)
    out = out.at[tri_rows[:, 2]].add(values2)
    return out


def barycentric_vertex_areas(geo: TriangleGeometry, tri_rows: jnp.ndarray, n_rows: int):
    third = geo.area / 3.0
    return scatter_add_rows(third, third, third, tri_rows, n_rows)


def vertex_normals(
    geo: TriangleGeometry, tri_rows: jnp.ndarray, tri_valid: jnp.ndarray, n_rows: int
) -> jnp.ndarray:
    """Area-weighted unit vertex normals (zero where the accumulation vanishes)."""
    n = jnp.where(tri_valid[:, None], geo.normal, 0.0)
    acc = scatter_add_rows(n, n, n, tri_rows, n_rows)
    norms = safe_norm(acc, eps=1e-15)
    return jnp.where(norms[:, None] > 1e-15, acc / jnp.maximum(norms, 1e-15)[:, None], 0.0)


def p1_shape_gradients(geo: TriangleGeometry) -> jnp.ndarray:
    """P1 per-triangle shape gradients, shape (F, 3 corners, 3 xyz).

    g_i = (n x e_i) / |n|^2 with e_i the edge opposite corner i
    (e_0 = v2 - v1, e_1 = v0 - v2, e_2 = v1 - v0).
    """
    e0 = geo.v2 - geo.v1
    e1 = geo.v0 - geo.v2
    e2 = geo.v1 - geo.v0
    inv_n2 = 1.0 / jnp.maximum(geo.double_area**2, EPS_AREA**2)
    g0 = jnp.cross(geo.normal, e0) * inv_n2[:, None]
    g1 = jnp.cross(geo.normal, e1) * inv_n2[:, None]
    g2 = jnp.cross(geo.normal, e2) * inv_n2[:, None]
    return jnp.stack([g0, g1, g2], axis=1)


def kink_threshold(dtype) -> float:
    """|K|-kink fallback threshold, above the dtype's cancellation noise.

    Used wherever the mean-curvature direction K/|K| must fall back to the
    vertex normal near the flat state (directional_norm's JVP and the
    bending-tilt shape-gradient surrogate's stop-gradient coefficients).
    See the JVP comment below for the measured noise scales.
    """
    return 1e-15 if jnp.dtype(dtype) == jnp.float64 else 1e-5


@jax.custom_jvp
def directional_norm(vecs: jnp.ndarray, fallback_dirs: jnp.ndarray) -> jnp.ndarray:
    """Row norms whose gradient direction falls back to ``fallback_dirs`` at 0.

    Parity: the reference's bending backprop uses K_dir = K/|K| when
    |K| > 1e-15 and the vertex normal otherwise (bending.py:155-160,
    bending_tilt_leaflet.py:556-563).  The |K| kink at flat states is thus
    resolved along the surface normal — this one-sided choice is what lets the
    curvature-divergence cross term buckle a perfectly flat membrane, so AD
    must reproduce it rather than returning the symmetric (zero) derivative.
    """
    return jnp.linalg.norm(vecs, axis=-1)


@directional_norm.defjvp
def _directional_norm_jvp(primals, tangents):
    vecs, fallback = primals
    dvecs, _dfall = tangents
    mag = jnp.linalg.norm(vecs, axis=-1)
    # The kink threshold must sit ABOVE the dtype's cancellation noise:
    # on a coplanar patch K is a sum of O(1) cotan-weighted terms that
    # cancel exactly, leaving |K| ~ eps(dtype) * O(1) of pure noise whose
    # direction is random.  f64 noise ~1e-16 < 1e-15 (the reference's own
    # threshold, bending.py:155-160).  f32 noise is ~1e-7..1e-6 (measured
    # on the kozlov flat disk: max 6.4e-8 per-row, 9e-7 at p90 across the
    # mesh), so 1e-15 routed f32 flat rows through the noise direction and
    # the shape gradient came out O(1) wrong (2.2 abs on |g|=4.2, round-5
    # f32-parity investigation).  1e-5 keeps 10x margin above the noise;
    # genuinely curved rows below it lose nothing — their true K direction
    # IS the vertex normal (K = 2 H A n_hat) to first order, which is
    # exactly the fallback.
    thresh = kink_threshold(vecs.dtype)
    use_dir = mag > thresh
    direction = jnp.where(
        use_dir[..., None], vecs / jnp.maximum(mag, thresh)[..., None], fallback
    )
    return mag, jnp.sum(direction * dvecs, axis=-1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CurvatureData:
    """Cotan-Laplacian data per Meyer et al. 2003."""

    k_vecs: jnp.ndarray  # (V, 3) integrated mean-curvature vectors
    vertex_areas: jnp.ndarray  # (V,) mixed-Voronoi areas
    weights: jnp.ndarray  # (F, 3) per-corner cotangents (c0, c1, c2)
    corner_areas: jnp.ndarray  # (F, 3) per-corner mixed-area contributions


def curvature_data(
    positions: jnp.ndarray,
    tri_rows: jnp.ndarray,
    tri_valid: jnp.ndarray,
    n_rows: int,
) -> CurvatureData:
    v0 = positions[tri_rows[:, 0]]
    v1 = positions[tri_rows[:, 1]]
    v2 = positions[tri_rows[:, 2]]
    e0 = v2 - v1  # opposite corner 0
    e1 = v0 - v2  # opposite corner 1
    e2 = v1 - v0  # opposite corner 2

    l0_sq = _dot(e0, e0)
    l1_sq = _dot(e1, e1)
    l2_sq = _dot(e2, e2)

    dbl = jnp.maximum(safe_norm(jnp.cross(e1, e2)), EPS_AREA)
    c0 = _dot(-e1, e2) / dbl
    c1 = _dot(-e2, e0) / dbl
    c2 = _dot(-e0, e1) / dbl

    mask = tri_valid.astype(positions.dtype)
    k0 = 0.5 * (c1[:, None] * (-e1) + c2[:, None] * e2) * mask[:, None]
    k1 = 0.5 * (c2[:, None] * (-e2) + c0[:, None] * e0) * mask[:, None]
    k2 = 0.5 * (c0[:, None] * (-e0) + c1[:, None] * e1) * mask[:, None]
    k_vecs = scatter_add_rows(k0, k1, k2, tri_rows, n_rows)

    tri_areas = 0.5 * dbl
    obt0 = c0 < 0
    obt1 = c1 < 0
    obt2 = c2 < 0
    any_obt = obt0 | obt1 | obt2

    va0 = jnp.where(~any_obt, (l1_sq * c1 + l2_sq * c2) / 8.0, 0.0)
    va1 = jnp.where(~any_obt, (l2_sq * c2 + l0_sq * c0) / 8.0, 0.0)
    va2 = jnp.where(~any_obt, (l0_sq * c0 + l1_sq * c1) / 8.0, 0.0)
    va0 = jnp.where(obt0, tri_areas / 2.0, va0)
    va0 = jnp.where(obt1 | obt2, tri_areas / 4.0, va0)
    va1 = jnp.where(obt1, tri_areas / 2.0, va1)
    va1 = jnp.where(obt0 | obt2, tri_areas / 4.0, va1)
    va2 = jnp.where(obt2, tri_areas / 2.0, va2)
    va2 = jnp.where(obt0 | obt1, tri_areas / 4.0, va2)
    va0 = va0 * mask
    va1 = va1 * mask
    va2 = va2 * mask
    vertex_areas = scatter_add_rows(va0, va1, va2, tri_rows, n_rows)

    weights = jnp.stack([c0, c1, c2], axis=1) * mask[:, None]
    corner_areas = jnp.stack([va0, va1, va2], axis=1)
    return CurvatureData(
        k_vecs=k_vecs, vertex_areas=vertex_areas, weights=weights, corner_areas=corner_areas
    )


def interior_angles(
    positions: jnp.ndarray, tri_rows: jnp.ndarray, tri_valid: jnp.ndarray
) -> jnp.ndarray:
    """Per-corner interior angles, shape (F, 3); zero on invalid rows."""
    v0 = positions[tri_rows[:, 0]]
    v1 = positions[tri_rows[:, 1]]
    v2 = positions[tri_rows[:, 2]]

    def corner_angle(p, a, b):
        u = a - p
        w = b - p
        nu = jnp.linalg.norm(u, axis=1)
        nw = jnp.linalg.norm(w, axis=1)
        cosang = _dot(u, w) / jnp.maximum(nu * nw, _tiny(positions.dtype))
        return jnp.arccos(jnp.clip(cosang, -1.0, 1.0))

    a0 = corner_angle(v0, v1, v2)
    a1 = corner_angle(v1, v2, v0)
    a2 = corner_angle(v2, v0, v1)
    angles = jnp.stack([a0, a1, a2], axis=1)
    return jnp.where(tri_valid[:, None], angles, 0.0)


def angle_defects(
    positions: jnp.ndarray,
    tri_rows: jnp.ndarray,
    tri_valid: jnp.ndarray,
    vertex_valid: jnp.ndarray,
    boundary_vertex_mask: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Integrated Gaussian curvature 2*pi - sum(angles); boundary rows zeroed."""
    n_rows = positions.shape[0]
    ang = interior_angles(positions, tri_rows, tri_valid)
    angle_sum = scatter_add_rows(ang[:, 0], ang[:, 1], ang[:, 2], tri_rows, n_rows)
    defects = jnp.where(vertex_valid, 2.0 * jnp.pi - angle_sum, 0.0)
    # vertices with no incident triangles contribute nothing
    defects = jnp.where(angle_sum > 0, defects, 0.0)
    if boundary_vertex_mask is not None:
        defects = jnp.where(boundary_vertex_mask, 0.0, defects)
    return defects


def min_edge_length(
    positions: jnp.ndarray, edge_rows: jnp.ndarray, edge_valid: jnp.ndarray
) -> jnp.ndarray:
    vecs = positions[edge_rows[:, 1]] - positions[edge_rows[:, 0]]
    lengths = jnp.linalg.norm(vecs, axis=1)
    return jnp.min(jnp.where(edge_valid, lengths, jnp.inf))


def edge_lengths(
    positions: jnp.ndarray, edge_rows: jnp.ndarray, edge_valid: jnp.ndarray
) -> jnp.ndarray:
    vecs = positions[edge_rows[:, 1]] - positions[edge_rows[:, 0]]
    return jnp.where(edge_valid, jnp.linalg.norm(vecs, axis=1), 0.0)


def body_volumes(
    positions: jnp.ndarray,
    tri_rows: jnp.ndarray,
    tri_valid: jnp.ndarray,
    tri_body: jnp.ndarray,
    nb_cap: int,
) -> jnp.ndarray:
    """Divergence-theorem volumes per body slot: sum v0.(v1 x v2)/6 over facets."""
    v0 = positions[tri_rows[:, 0]]
    v1 = positions[tri_rows[:, 1]]
    v2 = positions[tri_rows[:, 2]]
    contrib = jnp.where(tri_valid, _dot(jnp.cross(v1, v2), v0) / 6.0, 0.0)
    return jax.ops.segment_sum(contrib, tri_body, num_segments=nb_cap + 1)[:nb_cap]


def project_to_tangent(
    field: jnp.ndarray, normals: jnp.ndarray
) -> jnp.ndarray:
    """Remove the normal component of a per-vertex vector field."""
    return field - _dot(field, normals)[:, None] * normals


def check_normal_rotation(
    old_positions: jnp.ndarray,
    new_positions: jnp.ndarray,
    tri_rows: jnp.ndarray,
    tri_valid: jnp.ndarray,
    limit_radians: float = 0.5,
) -> jnp.ndarray:
    """True when no valid triangle's normal rotates more than the limit.

    Parity: reference runtime/topology.py:13-48 (collapsed new normals fail).
    """
    def normals_of(p):
        a = p[tri_rows[:, 0]]
        b = p[tri_rows[:, 1]]
        c = p[tri_rows[:, 2]]
        n = jnp.cross(b - a, c - a)
        return n, jnp.linalg.norm(n, axis=1)

    n_old, norm_old = normals_of(old_positions)
    n_new, norm_new = normals_of(new_positions)
    good_old = tri_valid & (norm_old > EPS_AREA)
    collapsed = good_old & (norm_new < EPS_AREA)
    cosang = _dot(n_old, n_new) / jnp.maximum(norm_old * norm_new, _tiny(old_positions.dtype))
    angle = jnp.arccos(jnp.clip(cosang, -1.0, 1.0))
    rotated_too_far = good_old & (angle > limit_radians)
    return ~(jnp.any(collapsed) | jnp.any(rotated_too_far))
