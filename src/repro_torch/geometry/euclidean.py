"""Euclidean "manifold": the identity geometry for unconstrained leaves.

Mirrors ``src/repro/geometry/euclidean.py``.  Every operation collapses to
its trivial form; ``consensus_step`` and ``descent_update`` use the
gradient-tracking form ``x + alpha([W x]_i - x) - beta u`` (GT-GDA's
update), written in the JAX package's order of operations.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.geometry.base import Manifold, register

Tensor = torch.Tensor


class Euclidean(Manifold):
    name = "euclidean"
    retractions = ("add",)
    default_retraction = "add"

    def tangent_project(self, x: Tensor, g: Tensor) -> Tensor:
        return g

    def retract(self, x: Tensor, u: Tensor, kind: Optional[str] = None,
                **kw) -> Tensor:
        return x + u

    def project(self, a: Tensor, method: str = "ns") -> Tensor:
        return a

    def dist(self, x: Tensor, y: Tensor) -> Tensor:
        dims = tuple(range(-min(x.ndim, 2), 0))
        return torch.sqrt(((x - y) ** 2).sum(dim=dims))

    def rand(self, d: int, r: int, batch: tuple[int, ...] = (), *,
             generator: torch.Generator, device) -> Tensor:
        return torch.randn((*batch, d, r), generator=generator).to(device)

    def check(self, x: Tensor) -> Tensor:
        return torch.zeros(x.shape[:-2] if x.ndim >= 2 else (),
                           device=x.device)

    def consensus_step(self, x: Tensor, mx: Tensor, alpha: float) -> Tensor:
        return alpha * (mx - x)

    def descent_update(self, x: Tensor, mx: Tensor, u: Tensor, *,
                       alpha: float, beta: float, kind=None, **kw) -> Tensor:
        # the summation order of the JAX package, for matching trajectories
        return x + alpha * (mx - x) - beta * u

    def feasible_init(self, x: Tensor) -> Tensor:
        return x


EUCLIDEAN = register(Euclidean())
