"""Grassmann manifold Gr(d, r): r-dimensional subspaces of R^d.

Mirrors ``src/repro/geometry/grassmann.py``.  Points are orthonormal bases
(Stiefel matrices); two bases of the same subspace are the same point.  The
horizontal space at ``x`` is {u : x^T u = 0}, and

    P_{H_x}(g) = g - x (x^T g)

with NO symmetrization, unlike Stiefel's Eq. 3 (so it is not
``ops.stiefel_project``: plain tensor products, as the JAX package computes
it outside any kernel).  Retractions re-orthonormalize ``x + u`` (polar,
QR); the consensus mean projects the Euclidean mean of the bases; ``dist``
is the arc length, the norm of the principal angles.

On Gr(d, d) the horizontal space is {0}: every projection is rounding noise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.geometry import stiefel as S
from repro_torch.geometry.base import Manifold, register

Tensor = torch.Tensor


def horizontal_project(x: Tensor, g: Tensor) -> Tensor:
    """P_{H_x}(g) = g - x (x^T g): projection onto the horizontal space."""
    xtg = torch.einsum("...dr,...ds->...rs", x, g)
    return g - torch.einsum("...dr,...rs->...ds", x, xtg)


def principal_angles(x: Tensor, y: Tensor) -> Tensor:
    """Principal angles between span(x) and span(y), ascending, in
    [0, pi/2].  Near 0 they carry fp32 rounding of about 5e-4
    (arccos(1 - delta) ~ sqrt(2 delta))."""
    s = torch.linalg.svdvals(torch.einsum("...dr,...ds->...rs", x, y))
    return torch.arccos(s.clamp(-1.0, 1.0)).flip(-1)


class Grassmann(Manifold):
    """Gr(d, r) via orthonormal representatives (last two dims)."""

    name = "grassmann"
    retractions = ("polar", "qr")
    default_retraction = "polar"
    requires_tall = True

    def tangent_project(self, x: Tensor, g: Tensor) -> Tensor:
        return horizontal_project(x, g)

    def retract(self, x: Tensor, u: Tensor, kind: Optional[str] = None,
                *, method: str = "ns", **kw) -> Tensor:
        kind = kind or self.default_retraction
        if kind == "polar":
            # (x+u)^T (x+u) = I + u^T u for horizontal u: Stiefel's Lemma 1
            return S.retract_polar(x, u, method=method)
        if kind == "qr":
            return S.retract_qr(x, u)
        raise ValueError(f"unknown retraction {kind!r}")

    def project(self, a: Tensor, method: str = "ns") -> Tensor:
        # the polar factor: an orthonormal basis of a's dominant subspace
        return S.project_stiefel(a, method)

    def dist(self, x: Tensor, y: Tensor) -> Tensor:
        """Geodesic (arc-length) distance: || principal angles ||_2."""
        return torch.linalg.vector_norm(principal_angles(x, y), dim=-1)

    def rand(self, d: int, r: int, batch: tuple[int, ...] = (), *,
             generator: torch.Generator, device) -> Tensor:
        return S.random_stiefel(d, r, batch, generator=generator,
                                device=device)

    def check(self, x: Tensor) -> Tensor:
        # representative feasibility: an orthonormal basis
        return S.stiefel_error(x)

    def feasible_init(self, x: Tensor) -> Tensor:
        return S.retract_qr(torch.zeros_like(x), x)


GRASSMANN = register(Grassmann())
