"""Problem interface for decentralized Riemannian minimax optimization.

Mirrors ``src/repro/core/minimax.py``.  A :class:`MinimaxProblem` packages

  * ``loss_fn(x, y, batch) -> scalar``: the *local* objective f_i of one
    node (min over the parameter dict ``x``, max over ``y``);
  * ``project_y``: Euclidean projection onto the compact convex set Y,
    acting on the last axis (so it takes node-stacked ``y`` as it is);
  * ``manifold_map``: a dict of the same keys as ``x`` naming each leaf's
    geometry (registry names or Manifold instances);
  * optionally ``y_star(x, batches)``: the exact inner maximizer, used by
    the convergence metric M_t (Eq. 16).

The node dimension is not part of this interface: the optimizers batch the
problem over the leading node axis with ``torch.func.vmap``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.func import grad

from repro_torch.geometry import (Product, as_manifold_map,
                                  tangent_project_tree)
from repro_torch.tree import tree_flatten

Tensor = torch.Tensor


def project_simplex(y: Tensor) -> Tensor:
    """Euclidean projection onto the probability simplex (last axis), by
    the sort-based algorithm (Held et al.)."""
    k = y.shape[-1]
    u = torch.sort(y, dim=-1, descending=True).values
    css = torch.cumsum(u, dim=-1) - 1.0
    idx = torch.arange(1, k + 1, dtype=y.dtype, device=y.device)
    cond = u - css / idx > 0
    rho = cond.sum(dim=-1, keepdim=True)  # >= 1 always
    theta = torch.gather(css, -1, rho - 1) / rho.to(y.dtype)
    return torch.clamp(y - theta, min=0.0)


@dataclasses.dataclass(frozen=True)
class MinimaxProblem:
    """min_{x in M} max_{y in Y} f(x, y; data): one node's local view."""

    loss_fn: Callable[[dict, Tensor, Any], Tensor]
    project_y: Callable[[Tensor], Tensor]
    manifold_map: Any
    y_star: Optional[Callable[[dict, Any], Tensor]] = None
    name: str = "problem"

    def __post_init__(self):
        object.__setattr__(self, "manifold_map",
                           as_manifold_map(self.manifold_map))

    @property
    def manifold(self) -> Product:
        """The product geometry over the whole parameter tree."""
        return Product(self.manifold_map)

    def grads(self, x: dict, y: Tensor, batch: Any) -> tuple[dict, Tensor]:
        """(euclidean grad_x, grad_y) of the local loss at (x, y)."""
        return grad(self.loss_fn, argnums=(0, 1))(x, y, batch)

    def rgrads(self, x: dict, y: Tensor, batch: Any) -> tuple[dict, Tensor]:
        """(Riemannian grad_x, euclidean grad_y): constrained leaves are
        tangent-projected at their own base point, the leaves of one
        geometry in one call."""
        gx, gy = self.grads(x, y, batch)
        rgx = tangent_project_tree(self.manifold_map, x, gx)
        return rgx, gy

    def value(self, x: dict, y: Tensor, batch: Any) -> Tensor:
        return self.loss_fn(x, y, batch)


def validate_manifold(params: dict, manifold_map: Any) -> Tensor:
    """Max feasibility residual over all constrained leaves (0.0 if none)."""
    errs = [m.check(x).max()
            for m, x in zip(tree_flatten(as_manifold_map(manifold_map))[0],
                            tree_flatten(params)[0])
            if m.name != "euclidean"]
    if not errs:
        return torch.zeros(())
    return torch.stack(errs).max()
