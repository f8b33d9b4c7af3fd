"""Oblique manifold OB(d, r) and the unit sphere: norm constraints.

Mirrors ``src/repro/geometry/oblique.py``.  ``Oblique`` is the product of r
unit spheres S^{d-1}, one per column of the (d, r) leaf (x^T x has a unit
diagonal); ``Sphere`` treats the whole block as one unit-Frobenius-norm
vector.  Every operation is elementwise work and a reduction: no Gram
matrix, no inverse square root.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.geometry.base import Manifold, register

Tensor = torch.Tensor

_EPS = 1e-12


def _colnorm(x: Tensor) -> Tensor:
    return torch.sqrt((x * x).sum(dim=-2, keepdim=True))


class Oblique(Manifold):
    """Unit-norm columns over the last two dims."""

    name = "oblique"
    retractions = ("normalize",)
    default_retraction = "normalize"

    def tangent_project(self, x: Tensor, g: Tensor) -> Tensor:
        # per column: g_c - x_c <x_c, g_c>   (x_c unit)
        return g - x * (x * g).sum(dim=-2, keepdim=True)

    def retract(self, x: Tensor, u: Tensor, kind: Optional[str] = None,
                **kw) -> Tensor:
        return self.project(x + u)

    def project(self, a: Tensor, method: str = "ns") -> Tensor:
        return a / _colnorm(a).clamp_min(_EPS)

    def dist(self, x: Tensor, y: Tensor) -> Tensor:
        """Geodesic: sqrt(sum of squared per-column great-circle angles)."""
        cos = (x * y).sum(dim=-2).clamp(-1.0, 1.0)
        return torch.linalg.vector_norm(torch.arccos(cos), dim=-1)

    def rand(self, d: int, r: int, batch: tuple[int, ...] = (), *,
             generator: torch.Generator, device) -> Tensor:
        return self.project(torch.randn((*batch, d, r), generator=generator)
                            .to(device))

    def check(self, x: Tensor) -> Tensor:
        return torch.linalg.vector_norm(_colnorm(x)[..., 0, :] - 1.0, dim=-1)


class Sphere(Manifold):
    """Unit Frobenius norm over the whole (d, r) block."""

    name = "sphere"
    retractions = ("normalize",)
    default_retraction = "normalize"

    def tangent_project(self, x: Tensor, g: Tensor) -> Tensor:
        return g - x * (x * g).sum(dim=(-2, -1), keepdim=True)

    def retract(self, x: Tensor, u: Tensor, kind: Optional[str] = None,
                **kw) -> Tensor:
        return self.project(x + u)

    def project(self, a: Tensor, method: str = "ns") -> Tensor:
        nrm = torch.sqrt((a * a).sum(dim=(-2, -1), keepdim=True))
        return a / nrm.clamp_min(_EPS)

    def dist(self, x: Tensor, y: Tensor) -> Tensor:
        cos = (x * y).sum(dim=(-2, -1)).clamp(-1.0, 1.0)
        return torch.arccos(cos)

    def rand(self, d: int, r: int, batch: tuple[int, ...] = (), *,
             generator: torch.Generator, device) -> Tensor:
        return self.project(torch.randn((*batch, d, r), generator=generator)
                            .to(device))

    def check(self, x: Tensor) -> Tensor:
        return torch.abs(torch.sqrt((x * x).sum(dim=(-2, -1))) - 1.0)


OBLIQUE = register(Oblique())
SPHERE = register(Sphere())
