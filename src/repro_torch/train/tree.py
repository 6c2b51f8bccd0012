"""Parameter trees: nested dicts and lists of tensors.

A list is a stack of layers (the reference stacks them on a leading axis);
:func:`tree_map` reports how many lists enclose each leaf, so a function
can count that axis as the reference's stacked leaf does.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn: Callable, tree: Any, *rest: Any, with_depth: bool = False,
             _depth: int = 0) -> Any:
    """``fn(leaf, *other_leaves)`` over trees of one structure (the first
    tree's keys); ``with_depth`` passes the number of enclosing lists as
    ``fn``'s first argument."""
    kw = dict(with_depth=with_depth)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), _depth=_depth,
                            **kw) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest), _depth=_depth + 1,
                         **kw) for i, v in enumerate(tree)]
    return fn(_depth, tree, *rest) if with_depth else fn(tree, *rest)


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The leaves in the tree's order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]
