"""A small tree map over nested dicts, lists and tuples.

The port's parameter trees are plain dicts of tensors (the JAX package's
pytrees); every other object is a leaf.  Dicts are walked in key order of
the first tree, and every tree passed to :func:`tree_map` must have the
same structure.  :func:`tree_flatten_with_path` also walks the fields of
NamedTuples and dataclasses (optimizer states) and names every leaf, for
checkpoints; the other functions, on the main path, build no paths.
"""
from __future__ import annotations

import dataclasses
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
    Per-leaf draws are indexed by this order, as ``jax.tree.flatten``'s.
    Builds no paths (see :func:`tree_flatten_with_path`)."""
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


def _children(tree: Tree):
    """(path parts, children, rebuild) of a node, or None for a leaf.  Dict
    keys in sorted order; NamedTuple and dataclass fields as ``.name``, as
    ``jax.tree_util`` names a NamedTuple's; ``None`` has no children."""
    if tree is None:
        return [], [], lambda vals: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ([str(k) for k in keys], [tree[k] for k in keys],
                lambda vals: {k: vals[keys.index(k)] for k in tree})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return ([f".{f}" for f in tree._fields], list(tree),
                lambda vals: type(tree)(*vals))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return ([f".{n}" for n in names], [getattr(tree, n) for n in names],
                lambda vals: dataclasses.replace(tree, **dict(zip(names,
                                                                  vals))))
    if isinstance(tree, (list, tuple)):
        return ([str(i) for i in range(len(tree))], list(tree),
                lambda vals: type(tree)(vals))
    return None


def tree_flatten_with_path(tree: Tree,
                           is_leaf: Callable[[Any], bool] | None = None
                           ) -> tuple[list[str], list, Callable[[list], Tree]]:
    """``(paths, leaves, unflatten)`` in the JAX package's flatten order:
    dict keys sorted, NamedTuple and dataclass fields in declaration order
    (path part ``.field``), ``None`` an empty subtree; a path joins its
    parts with ``/``, as ``repro.checkpoint`` writes them.  ``unflatten``
    builds a tree of this structure from such a list of leaves.  A node
    for which ``is_leaf`` is true is one leaf."""
    node = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if node is None:
        return [""], [tree], lambda leaves: leaves[0]
    parts, kids, rebuild = node
    paths, leaves, builds, sizes = [], [], [], []
    for part, kid in zip(parts, kids):
        p, lv, b = tree_flatten_with_path(kid, is_leaf)
        paths += [f"{part}/{q}" if q else part for q in p]
        leaves += lv
        builds.append(b)
        sizes.append(len(lv))

    def unflatten(flat: list) -> Tree:
        vals, at = [], 0
        for b, size in zip(builds, sizes):
            vals.append(b(flat[at:at + size]))
            at += size
        return rebuild(vals)

    return paths, leaves, unflatten
