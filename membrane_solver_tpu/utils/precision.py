"""Precision selection.

The solver is float64 by default (the reference is f64 NumPy throughout);
MEMBRANE_SOLVER_X64=0 selects float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def default_float():
    """The working float dtype under the current x64 setting."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def tiny(dtype) -> float:
    """A division-guard floor that stays representable in ``dtype``.

    The f64 lanes use 1e-300 floors (parity with the reference's NumPy
    guards); in float32 those underflow to 0.0 and stop guarding, so the
    f32 lane floors at 1e-30 (well above the 1.2e-38 minimum normal).
    """
    return 1e-300 if jnp.dtype(dtype) == jnp.float64 else 1e-30


def tiny_like(x) -> float:
    return tiny(x.dtype)


def fmax_tiny(x):
    """``maximum(x, tiny)`` with a floor representable in x's dtype."""
    x = jnp.asarray(x)
    return jnp.maximum(x, tiny(x.dtype))


def degen(dtype) -> float:
    """Near-zero threshold for squared magnitudes (eigen/degeneracy tests)."""
    return 1e-280 if jnp.dtype(dtype) == jnp.float64 else 1e-26
