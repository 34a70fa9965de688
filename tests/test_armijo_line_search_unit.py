"""Direct unit lanes for the functional Armijo backtracking line search.

Parity: reference runtime/steppers/line_search.py:261-529 — Armijo accept
threshold, 0.7 backtracking, 1.5x growth capped at 10x, non-descent skip,
normal-flip safety, decrease_only rule; plus the batched form's
contract that its decisions are identical to the sequential loop.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from membrane_solver_tpu import Minimizer, load_data, parse_geometry
from membrane_solver_tpu.runtime import jit_core


@pytest.fixture(scope="module")
def prob():
    mesh = parse_geometry(load_data("meshes/cube.json"))
    mesh.instructions = []
    return Minimizer(mesh, quiet=True).problem()


def _quadratic(p, shift=0.25):
    """E(state) = |positions - target|^2 over valid rows."""
    target = jnp.where(
        p.topo.vertex_valid[:, None], p.state.positions + shift, p.state.positions
    )

    def energy_of_state(state):
        d = jnp.where(p.topo.vertex_valid[:, None], state.positions - target, 0.0)
        return jnp.sum(d * d)

    return energy_of_state


def _search(p, energy, step, direction=None, accept_rule="armijo"):
    state = p.state
    grad = jnp.where(
        p.topo.vertex_valid[:, None],
        2.0 * (state.positions - state.positions - 0.25),
        0.0,
    )  # analytic grad of the quadratic at the base point: -2*shift
    if direction is None:
        direction = -grad
    movable = p.topo.vertex_valid & ~p.topo.fixed_mask
    return jit_core.armijo_line_search(
        energy,
        state,
        grad,
        direction,
        jnp.asarray(float(step)),
        energy(state),
        movable,
        p.topo,
        lambda trial: dataclasses.replace(state, positions=trial),
        accept_rule=accept_rule,
    )


def test_immediate_accept_grows_step(prob):
    energy = _quadratic(prob)
    res = _search(prob, energy, step=0.05)
    assert bool(res.success)
    assert float(res.energy) < float(energy(prob.state))
    # growth: accepted alpha * 1.5, capped at 10x the entry step
    assert abs(float(res.new_step) - 0.05 * 1.5) < 1e-12


def test_backtracks_match_hand_simulation(prob):
    energy = _quadratic(prob)
    e0 = float(energy(prob.state))
    big = 5.0  # overshoots: E(alpha) = sum (alpha*2s - s)^2 rises for alpha > 1
    res = _search(prob, energy, step=big)
    assert bool(res.success)
    # hand-simulate the sequential chain to find the first accepted alpha
    state = prob.state
    grad = -2.0 * 0.25 * np.ones(3)
    alpha = big
    for _ in range(jit_core.LS_MAX_ITER):
        trial = np.asarray(state.positions) + alpha * (
            -np.where(np.asarray(prob.topo.vertex_valid)[:, None], grad, 0.0)
        )
        d = np.where(
            np.asarray(prob.topo.vertex_valid)[:, None],
            trial - (np.asarray(state.positions) + 0.25),
            0.0,
        )
        E_t = float(np.sum(d * d))
        slope = float(
            np.sum(
                np.where(np.asarray(prob.topo.vertex_valid)[:, None], grad, 0.0)
                * -np.where(np.asarray(prob.topo.vertex_valid)[:, None], grad, 0.0)
            )
        )
        if E_t <= e0 + jit_core.LS_C * alpha * slope:
            break
        alpha *= jit_core.LS_BETA
    accepted = float(res.energy)
    assert abs(accepted - E_t) < 1e-9


def test_non_descent_direction_skips_search(prob):
    energy = _quadratic(prob)
    # direction = +grad: uphill
    grad_arr = jnp.where(
        prob.topo.vertex_valid[:, None], jnp.full_like(prob.state.positions, -0.5), 0.0
    )
    res = jit_core.armijo_line_search(
        energy,
        prob.state,
        grad_arr,
        grad_arr,  # d = g -> g.d > 0
        jnp.asarray(0.1),
        energy(prob.state),
        prob.topo.vertex_valid & ~prob.topo.fixed_mask,
        prob.topo,
        lambda trial: dataclasses.replace(prob.state, positions=trial),
    )
    assert not bool(res.success)
    assert abs(float(res.new_step) - 0.1) < 1e-15  # step untouched
    assert np.allclose(
        np.asarray(res.state.positions), np.asarray(prob.state.positions)
    )


def test_decrease_only_accepts_flat_moves(prob):
    # constant energy: Armijo would reject (no strict decrease with slope 0
    # is accepted: E_t <= E0 passes) — decrease_only must accept alpha0
    def flat_energy(state):
        return jnp.asarray(1.0, state.positions.dtype)

    res = _search(prob, flat_energy, step=0.1, accept_rule="decrease_only")
    assert bool(res.success)
    assert abs(float(res.energy) - 1.0) < 1e-15


def test_failure_returns_baseline(prob):
    # energy increases for ANY move: every trial rejected
    base = prob.state.positions

    def rising(state):
        d = state.positions - base
        return jnp.sum(d * d) * 1e6 + jnp.sum(jnp.abs(d)) * 1e3

    grad_arr = jnp.where(
        prob.topo.vertex_valid[:, None], jnp.full_like(base, 1.0), 0.0
    )
    res = jit_core.armijo_line_search(
        rising,
        prob.state,
        grad_arr,
        -grad_arr,  # descent by sign, but the energy still rises
        jnp.asarray(0.1),
        rising(prob.state),
        prob.topo.vertex_valid & ~prob.topo.fixed_mask,
        prob.topo,
        lambda trial: dataclasses.replace(prob.state, positions=trial),
    )
    assert not bool(res.success)
    assert np.allclose(np.asarray(res.state.positions), np.asarray(base))
    assert abs(float(res.energy) - float(rising(prob.state))) < 1e-12
