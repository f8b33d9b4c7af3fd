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


def tree_flatten(tree: Tree) -> tuple[list, Callable[[list], Tree]]:
    """Leaves in the JAX package's flatten order (dict keys sorted), and a
    function that builds a tree of the same structure from such a list.
    Per-leaf draws are indexed by this order, as ``jax.tree.flatten``'s."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [tree_flatten(t) for t in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(leaves) for leaves, _ in parts]

    def unflatten(leaves: list) -> Tree:
        out, at = [], 0
        for (_, build), size in zip(parts, sizes):
            out.append(build(leaves[at:at + size]))
            at += size
        if keys is not None:
            return {k: out[keys.index(k)] for k in tree}
        return type(tree)(out)

    return [leaf for leaves, _ in parts for leaf in leaves], unflatten
