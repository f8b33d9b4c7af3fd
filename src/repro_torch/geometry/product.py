"""Product manifold over the port's parameter trees.

Mirrors ``src/repro/geometry/product.py``.  A :class:`Product` wraps a
per-leaf manifold map (see :func:`~repro_torch.geometry.base.as_manifold_map`)
and implements the protocol treewise, so a whole parameter tree (Stiefel
attention weights, oblique embeddings, Euclidean gates) has the surface of
one geometry.  Retraction kinds resolve per leaf (``resolve_retraction``):
one config string applies where a leaf supports it and falls back to the
leaf's default elsewhere.  The tangent projection groups the leaves of one
geometry (:func:`~repro_torch.geometry.base.tangent_project_tree`: on the
card one launch for every Stiefel leaf).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.geometry.base import (Manifold, as_manifold_map,
                                       tangent_project_tree)
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

Tensor = torch.Tensor
Tree = Any


def _is_manifold(s) -> bool:
    return isinstance(s, Manifold)


class Product(Manifold):
    """Treewise product of per-leaf manifolds."""

    name = "product"

    def __init__(self, manifold_map: Tree):
        self.map = as_manifold_map(manifold_map)

    def _zip(self, fn, *trees):
        return tree_map(fn, self.map, *trees, is_leaf=_is_manifold)

    # -- protocol ----------------------------------------------------------
    def tangent_project(self, x: Tree, g: Tree) -> Tree:
        return tangent_project_tree(self.map, x, g)

    def retract(self, x: Tree, u: Tree, kind: Optional[str] = None,
                **kw) -> Tree:
        return self._zip(
            lambda m, xi, ui: m.retract(xi, ui, m.resolve_retraction(kind),
                                        **kw), x, u)

    def project(self, a: Tree, method: str = "ns") -> Tree:
        return self._zip(lambda m, ai: m.project(ai, method=method), a)

    def consensus_mean(self, xs: Tree, method: str = "ns") -> Tree:
        return self._zip(lambda m, xi: m.consensus_mean(xi, method=method), xs)

    def dist(self, x: Tree, y: Tree) -> Tensor:
        sq = self._zip(lambda m, xi, yi: (m.dist(xi, yi) ** 2).sum(), x, y)
        return torch.sqrt(sum(tree_leaves(sq)))

    def rand(self, like: Tree, *, generator: torch.Generator,
             device) -> Tree:
        """A random point with the shapes of ``like`` (a tree of tensors or
        anything with ``.shape``): the leaves are drawn in the tree's
        flatten order from the one ``generator``."""
        ms, _ = tree_flatten(self.map)
        leaves, unflatten = tree_flatten(like)
        return unflatten([
            m.rand(leaf.shape[-2], leaf.shape[-1], tuple(leaf.shape[:-2]),
                   generator=generator, device=device)
            for m, leaf in zip(ms, leaves)])

    def check(self, x: Tree) -> Tensor:
        errs = tree_leaves(self._zip(lambda m, xi: m.check(xi).max(), x))
        return torch.stack(errs).max() if errs else torch.zeros(())

    # -- optimizer hooks ---------------------------------------------------
    def consensus_step(self, x: Tree, mx: Tree, alpha: float) -> Tree:
        return self._zip(lambda m, xi, mi: m.consensus_step(xi, mi, alpha),
                         x, mx)

    def feasible_init(self, x: Tree) -> Tree:
        return self._zip(lambda m, xi: m.feasible_init(xi), x)

    def __repr__(self):
        names = sorted({m.name for m in tree_leaves(self.map)})
        return f"Product({'+'.join(names)})"
