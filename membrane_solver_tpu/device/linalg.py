"""Small dense linear algebra for the KKT solves and 3x3 frame fits.

All dense systems in this codebase are tiny (3x3 frames, k x k KKT normal
equations with k <= a few hundred):

- ``solve_spd`` / ``make_dense_solver``: LU with partial pivoting
  (``jnp.linalg.solve`` / ``jax.scipy.linalg.lu_factor``) — the same
  factorization as the reference's ``np.linalg.solve``.
- ``smallest_eigvec_3x3`` / ``eigh_3x3``: closed-form symmetric 3x3
  eigendecomposition (trigonometric Cardano + cross-product eigenvectors) —
  replaces ``jnp.linalg.eigh``/``svd`` in plane/circle fitting, where the
  calls are batched over thousands of 3x3 systems.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from membrane_solver_tpu.utils.precision import degen as _degen, tiny as _tiny


def solve_spd(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve a (regularized, possibly near-singular) dense KKT system.

    Matches the reference's _solve_kkt_system
    (runtime/constraint_projection.py:57-67): numpy's Cholesky REJECTS the
    near-singular regularized systems these paths produce (duplicated
    constraint rows make A numerically semidefinite), so the reference's
    effective solver is np.linalg.solve — LU with partial pivoting, which is
    what this calls.  Singular systems yield non-finite solutions, which
    callers detect (skip semantics).  Single system ((n, n), (n,)) —
    batched callers vmap over it.
    """
    return jnp.linalg.solve(A, b)


def _eigvals_sym3(A):
    """Eigenvalues of symmetric 3x3 (ascending), trigonometric Cardano."""
    q = jnp.trace(A) / 3.0
    B = A - q * jnp.eye(3, dtype=A.dtype)
    p2 = jnp.sum(B * B) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, _tiny(p2.dtype)))
    detB = (
        B[0, 0] * (B[1, 1] * B[2, 2] - B[1, 2] * B[2, 1])
        - B[0, 1] * (B[1, 0] * B[2, 2] - B[1, 2] * B[2, 0])
        + B[0, 2] * (B[1, 0] * B[2, 1] - B[1, 1] * B[2, 0])
    )
    r = jnp.clip(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e1 = q + 2.0 * p * jnp.cos(phi)
    e3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    # degenerate (p ~ 0): all eigenvalues equal q
    is_degen = p2 < _degen(p2.dtype)
    return (
        jnp.where(is_degen, q, e3),
        jnp.where(is_degen, q, e2),
        jnp.where(is_degen, q, e1),
    )  # ascending


def _eigvec_for(A, lam, fallback):
    """Eigenvector of symmetric 3x3 for eigenvalue lam via row cross products."""
    M = A - lam * jnp.eye(3, dtype=A.dtype)
    c0 = jnp.cross(M[0], M[1])
    c1 = jnp.cross(M[0], M[2])
    c2 = jnp.cross(M[1], M[2])
    n0, n1, n2 = jnp.dot(c0, c0), jnp.dot(c1, c1), jnp.dot(c2, c2)
    best = jnp.where(
        (n0 >= n1) & (n0 >= n2), c0, jnp.where(n1 >= n2, c1, c2)
    )
    nbest = jnp.maximum(n0, jnp.maximum(n1, n2))
    v = jnp.where(
        nbest > _degen(A.dtype),
        best / jnp.sqrt(jnp.maximum(nbest, _tiny(A.dtype))),
        fallback,
    )
    return v


def smallest_eigvec_3x3(A: jnp.ndarray, fallback=None) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue of a symmetric 3x3."""
    if fallback is None:
        fallback = jnp.asarray([0.0, 0.0, 1.0], A.dtype)
    lam_min, _, _ = _eigvals_sym3(A)
    return _eigvec_for(A, lam_min, fallback)


def eigh_3x3(A: jnp.ndarray):
    """(eigenvalues ascending (3,), eigenvectors as columns (3,3)) of symmetric 3x3."""
    l0, l1, l2 = _eigvals_sym3(A)
    f0 = jnp.asarray([0.0, 0.0, 1.0], A.dtype)
    v0 = _eigvec_for(A, l0, f0)
    v2 = _eigvec_for(A, l2, jnp.asarray([1.0, 0.0, 0.0], A.dtype))
    # middle vector: orthogonal completion (robust against near-degenerate pairs)
    v1 = jnp.cross(v2, v0)
    n1 = jnp.linalg.norm(v1)
    v1 = jnp.where(
        n1 > _degen(A.dtype), v1 / jnp.maximum(n1, _tiny(A.dtype)), _eigvec_for(A, l1, f0)
    )
    return jnp.stack([l0, l1, l2]), jnp.stack([v0, v1, v2], axis=1)


def make_dense_solver(A: jnp.ndarray):
    """Return apply(b) solving A x = b: factor once, solve many.

    LU factorization (getrf) once and a pair of triangular solves (getrs)
    per apply — bit-identical to repeated np.linalg.solve on the CPU.
    """
    lu, piv = jsl.lu_factor(A)
    return lambda b: jsl.lu_solve((lu, piv), b)


def kabsch(P: jnp.ndarray, Q: jnp.ndarray):
    """Least-squares rigid transform (R, t) mapping P -> Q (Kabsch).

    The right singular vectors of H = P0^T Q0 come from the closed-form
    symmetric 3x3 eigendecomposition of H^T H; the improper-
    rotation case flips the smallest-singular-value direction, matching the
    reference's det correction (rigid_disk.py:84-100).
    """
    Pc = jnp.mean(P, axis=0)
    Qc = jnp.mean(Q, axis=0)
    P0 = P - Pc
    Q0 = Q - Qc
    H = P0.T @ Q0
    evals, V = eigh_3x3(H.T @ H)  # ascending
    eps = _tiny(H.dtype)
    sig = jnp.sqrt(jnp.maximum(evals, eps))
    U = (H @ V) / sig[None, :]
    # re-orthonormalize U against near-zero singular values
    u2 = U[:, 2] / jnp.maximum(jnp.linalg.norm(U[:, 2]), eps)
    u1 = U[:, 1] - jnp.dot(U[:, 1], u2) * u2
    u1 = u1 / jnp.maximum(jnp.linalg.norm(u1), eps)
    u0 = jnp.cross(u1, u2)
    U = jnp.stack([u0, u1, u2], axis=1)
    v2 = V[:, 2]
    v1 = V[:, 1] - jnp.dot(V[:, 1], v2) * v2
    v1 = v1 / jnp.maximum(jnp.linalg.norm(v1), eps)
    v0 = jnp.cross(v1, v2)
    V = jnp.stack([v0, v1, v2], axis=1)
    R = V @ U.T
    d = jnp.linalg.det(R)
    # flip the smallest-sigma column of V when improper
    Vf = V.at[:, 0].set(-V[:, 0])
    Rf = Vf @ U.T
    R = jnp.where(d < 0.0, Rf, R)
    t = Qc - R @ Pc
    return R, t
