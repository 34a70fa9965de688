"""Unit lanes for the dense linear algebra (device/linalg.py).

These back the KKT solves, the factor-once projector, the
pin-to-plane/circle fits (3x3 eigen), and the rigid-disk Kabsch transform;
each is checked against numpy on random instances.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from membrane_solver_tpu.device import linalg as dl


def _spd(n, seed=0, jitter=1.0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    return M @ M.T + jitter * np.eye(n)


@pytest.mark.parametrize("n", [1, 3, 12, 96])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_solve_spd_matches_numpy(n, dtype):
    A = _spd(n, seed=n).astype(dtype)
    b = np.random.default_rng(n + 1).standard_normal(n).astype(dtype)
    x = np.asarray(dl.solve_spd(jnp.asarray(A), jnp.asarray(b)))
    assert x.dtype == dtype
    tol = 1e-9 if dtype == np.float64 else 2e-3
    assert np.allclose(A.astype(np.float64) @ x, b, atol=tol * np.abs(b).max() * n)


def test_solve_spd_near_singular_regularized():
    # duplicated constraint rows make the Gram matrix semidefinite; with
    # the reference's regularization the solve must still go through
    A = _spd(5, seed=8, jitter=0.0)
    A[4] = A[3]  # exact duplicate row/col after symmetrization
    A[:, 4] = A[:, 3]
    A += 1e-10 * np.eye(5)
    b = np.random.default_rng(9).standard_normal(5)
    x = np.asarray(dl.solve_spd(jnp.asarray(A), jnp.asarray(b)))
    assert np.allclose(x, np.linalg.solve(A, b), atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_singular_system_returns_non_finite(dtype):
    """Exactly singular KKT systems must come back non-finite: the
    projection detects that and skips the step, as the reference does."""
    A = np.zeros((4, 4), dtype)
    A[:2, :2] = np.eye(2)  # rank 2 of 4
    b = np.ones(4, dtype)
    x = np.asarray(dl.solve_spd(jnp.asarray(A), jnp.asarray(b)))
    assert not np.all(np.isfinite(x))
    x = np.asarray(dl.make_dense_solver(jnp.asarray(A))(jnp.asarray(b)))
    assert not np.all(np.isfinite(x))


@pytest.mark.parametrize("n", [2, 12, 96])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_make_dense_solver_factor_once_apply_many(n, dtype):
    A = _spd(n, seed=11 + n).astype(dtype)
    apply = dl.make_dense_solver(jnp.asarray(A))
    tol = 1e-8 if dtype == np.float64 else 2e-3
    for seed in (12, 13, 14):
        b = np.random.default_rng(seed).standard_normal(n).astype(dtype)
        x = np.asarray(apply(jnp.asarray(b)))
        assert x.dtype == dtype
        assert np.allclose(A.astype(np.float64) @ x, b, atol=tol * np.abs(b).max() * n)
    # bit-identical to a fresh solve per right-hand side (LAPACK getrf+getrs)
    b = np.random.default_rng(15).standard_normal(n).astype(dtype)
    np.testing.assert_array_equal(
        np.asarray(apply(jnp.asarray(b))),
        np.asarray(dl.solve_spd(jnp.asarray(A), jnp.asarray(b))),
    )


def test_eigh_3x3_matches_numpy():
    rng = np.random.default_rng(15)
    for _ in range(20):
        M = rng.standard_normal((3, 3))
        A = M + M.T
        evals, evecs = dl.eigh_3x3(jnp.asarray(A))
        evals, evecs = np.asarray(evals), np.asarray(evecs)
        ref = np.linalg.eigvalsh(A)
        assert np.allclose(evals, ref, atol=1e-8)
        for k in range(3):
            v = evecs[:, k]
            assert np.allclose(A @ v, evals[k] * v, atol=1e-6)
            assert abs(np.linalg.norm(v) - 1.0) < 1e-8


def test_eigh_3x3_degenerate_pair():
    A = np.diag([2.0, 2.0, 5.0])  # repeated smallest pair
    evals, evecs = dl.eigh_3x3(jnp.asarray(A))
    assert np.allclose(np.asarray(evals), [2.0, 2.0, 5.0])
    v2 = np.asarray(evecs)[:, 2]
    assert np.allclose(np.abs(v2), [0, 0, 1], atol=1e-10)


def test_smallest_eigvec_is_plane_normal():
    # points scattered in the z=0 plane: smallest eigenvector of the
    # covariance is the plane normal (the pin_to_plane fit path)
    rng = np.random.default_rng(16)
    pts = rng.standard_normal((40, 3))
    pts[:, 2] = 0.0
    C = (pts - pts.mean(0)).T @ (pts - pts.mean(0))
    v = np.asarray(dl.smallest_eigvec_3x3(jnp.asarray(C)))
    assert np.allclose(np.abs(v), [0, 0, 1], atol=1e-10)


def test_kabsch_recovers_rotation_and_translation():
    rng = np.random.default_rng(17)
    # random proper rotation via QR
    Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    t = rng.standard_normal(3)
    P = rng.standard_normal((15, 3))
    target = P @ Q.T + t
    R, trans = dl.kabsch(jnp.asarray(P), jnp.asarray(target))
    R, trans = np.asarray(R), np.asarray(trans)
    assert np.allclose(R, Q, atol=1e-7)
    assert np.allclose(P @ R.T + trans, target, atol=1e-7)
    assert abs(np.linalg.det(R) - 1.0) < 1e-9


def test_kabsch_reflection_corrected_to_proper_rotation():
    # target is a mirror image: the lsq rigid transform must stay a PROPER
    # rotation (det +1), matching the reference's det correction
    rng = np.random.default_rng(18)
    P = rng.standard_normal((10, 3))
    target = P * np.array([1.0, 1.0, -1.0])
    R, trans = dl.kabsch(jnp.asarray(P), jnp.asarray(target))
    assert abs(float(jnp.linalg.det(R)) - 1.0) < 1e-9
