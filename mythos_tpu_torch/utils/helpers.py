"""Small helpers of the fitting loop.

Counterpart of mythos_tpu/utils/helpers.py: the tree helpers over nested
dicts, lists and tuples of tensors (the port has no pytrees) and
``try_to_float``. The subprocess helpers wait for the external engines.
"""

from __future__ import annotations

import contextlib
from collections.abc import Callable
from typing import Any

import torch


def tree_map(fn: Callable, *trees):
    """``fn`` over corresponding tensors of nested dicts, lists and tuples
    of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *parts) for parts in zip(*trees, strict=True))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict, list or tuple, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_concatenate(trees: list):
    """Concatenate corresponding tensors along the first axis."""
    return tree_map(lambda *v: torch.cat(v), *trees)


def try_to_float(value: Any) -> float | None:
    """float(value) or None."""
    with contextlib.suppress(Exception):
        return float(value)
    return None
