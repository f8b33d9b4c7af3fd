"""A small tree map over nested dicts, lists and tuples.

The port's parameter trees are plain dicts of tensors (the JAX package's
pytrees); every other object is a leaf.  Dicts are walked in key order of
the first tree, and every tree passed to :func:`tree_map` must have the
same structure.
"""
from __future__ import annotations

from typing import Any, Callable

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree,
             is_leaf: Callable[[Any], bool] | None = None) -> Tree:
    """``fn`` applied leafwise over trees of the same structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or other.keys() != tree.keys():
                raise ValueError(f"tree structures differ at keys "
                                 f"{list(tree)}")
        return {k: tree_map(fn, tree[k], *(o[k] for o in rest),
                            is_leaf=is_leaf) for k in tree}
    if isinstance(tree, (list, tuple)):
        for other in rest:
            if type(other) is not type(tree) or len(other) != len(tree):
                raise ValueError("tree structures differ")
        out = [tree_map(fn, t, *(o[i] for o in rest), is_leaf=is_leaf)
               for i, t in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """Leaves in the order :func:`tree_map` visits them."""
    out: list = []
    tree_map(out.append, tree)
    return out
