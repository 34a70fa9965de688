"""Safe-expression evaluator lanes (core/expr.py).

Parity: reference core/expr_eval.py — AST whitelist semantics; plus the
device twist: compile_expr produces a jit/vmap-traceable callable.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

from membrane_solver_tpu.core.expr import compile_expr, eval_expr, expr_free_names


def test_arithmetic_functions_and_constants():
    assert eval_expr("2 + 3 * 4") == 14.0
    assert eval_expr("2 ** 3 % 5") == 3.0
    assert eval_expr("-x + +y", {"x": 2.0, "y": 5.0}) == 3.0
    assert abs(eval_expr("sin(pi / 2)") - 1.0) < 1e-15
    assert abs(eval_expr("log(e)") - 1.0) < 1e-15
    assert eval_expr("min(3, 2)") == 2.0
    assert eval_expr("max(abs(-3), sqrt(16))") == 4.0


@pytest.mark.parametrize(
    "bad",
    [
        "__import__('os').system('true')",
        "().__class__",
        "open('/etc/passwd')",
        "[1,2][0]",
        "{'a': 1}",
        "'str'",
        "lambda: 1",
        "x if x else y",
        "a @ b",
        "x << 2",
    ],
)
def test_non_whitelisted_syntax_rejected(bad):
    with pytest.raises((ValueError, SyntaxError)):
        eval_expr(bad, {"x": 1.0, "y": 2.0, "a": 1.0, "b": 2.0})


def test_unknown_name_rejected():
    with pytest.raises(ValueError, match="Unknown name"):
        eval_expr("x + unknown_thing", {"x": 1.0})


def test_free_names_excludes_functions_and_constants():
    assert expr_free_names("sin(x) + pi * k_bend - e") == {"x", "k_bend"}


def test_compile_expr_vectorizes_under_jit():
    import jax
    import jax.numpy as jnp

    fn = compile_expr("sin(x) * y + sqrt(abs(z))", ["x", "y", "z"])
    x = jnp.linspace(0.0, 1.0, 8)
    y = jnp.full(8, 2.0)
    z = jnp.linspace(-1.0, 1.0, 8)
    out = jax.jit(fn)(x, y, z)
    expected = np.sin(np.asarray(x)) * 2.0 + np.sqrt(np.abs(np.asarray(z)))
    assert np.allclose(np.asarray(out), expected)


def test_compile_expr_arity_checked():
    fn = compile_expr("x + y", ["x", "y"])
    with pytest.raises(TypeError):
        fn(1.0)


def test_compile_expr_is_grad_friendly():
    import jax

    fn = compile_expr("x ** 2 + 3 * x", ["x"])
    g = jax.grad(lambda x: fn(x))(2.0)
    assert abs(float(g) - 7.0) < 1e-12
