"""TOML parameter-file loading with a small expression evaluator.

Counterpart of mythos_tpu/io/toml.py, which evaluates string leaves with
``sympy.parse_expr(...).evalf(32)``. This port has no sympy: string leaves
are parsed with :mod:`ast` and may hold numbers, ``pi`` and ``+ - * /``.
The floats agree with the sympy path exactly:

* without ``pi`` sympy folds float literals at double precision, operation
  by operation -- the same as Python float arithmetic;
* with ``pi`` sympy keeps the expression symbolic and evaluates it once at
  32 digits -- done here in exact rational arithmetic (each float literal
  taken at its double value, as sympy's 15-digit Float holds it, and pi to
  50 digits), rounded to a double once at the end.
"""

from __future__ import annotations

import ast
import tomllib
from fractions import Fraction
from pathlib import Path
from typing import Any

import numpy as np

_PI = Fraction("3.14159265358979323846264338327950288419716939937510")

_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b,
}


def _uses_pi(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Name) and n.id == "pi" for n in ast.walk(node))


def _eval(node: ast.AST, exact: bool):
    if isinstance(node, ast.Expression):
        return _eval(node.body, exact)
    if isinstance(node, ast.Constant) and type(node.value) in (int, float):
        if isinstance(node.value, int):
            return Fraction(node.value) if exact else node.value
        return Fraction(node.value) if exact else float(node.value)
    if isinstance(node, ast.Name) and node.id == "pi":
        return _PI
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        v = _eval(node.operand, exact)
        return -v if isinstance(node.op, ast.USub) else v
    if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
        return _BINOPS[type(node.op)](_eval(node.left, exact), _eval(node.right, exact))
    raise ValueError(f"unsupported expression element {ast.dump(node)}")


def eval_expr(text: str) -> float:
    """Evaluate a numeric expression of numbers, ``pi`` and ``+ - * /``."""
    tree = ast.parse(text.strip(), mode="eval")
    return float(_eval(tree, exact=_uses_pi(tree)))


def parse_str(value: str) -> str | float:
    """Parse a string to a float, trying an expression as fallback."""
    try:
        return float(value)
    except ValueError:
        try:
            return eval_expr(value)
        except (ValueError, SyntaxError, ZeroDivisionError):
            return value


def _map_strings(value):
    if isinstance(value, list):
        return [_map_strings(v) for v in value]
    return parse_str(value)


def _leaves(value) -> list:
    if isinstance(value, list):
        return [x for v in value for x in _leaves(v)]
    return [value]


def parse_value(value: Any) -> Any:
    """Parse a leaf value: strings via parse_str, float lists to arrays."""
    if isinstance(value, str):
        return parse_str(value)
    if isinstance(value, list):
        leaves = _leaves(value)
        if all(isinstance(x, str) for x in leaves):
            return _map_strings(value)
        if all(isinstance(x, float) for x in leaves):
            return np.array(value)
    return value


def _map_config(config):
    if isinstance(config, dict):
        return {k: _map_config(v) for k, v in config.items()}
    return parse_value(config)


def parse_toml(file_path: Path | str) -> dict[str, Any]:
    """Load a TOML file, evaluating expression-valued leaves."""
    with Path(file_path).open("rb") as f:
        return _map_config(tomllib.load(f))
