"""Stiefel primitives as flat functions: the facade of ``repro_torch.geometry``.

Mirrors ``src/repro/core/manifolds.py``.  The math lives in
:mod:`repro_torch.geometry.stiefel`; this module keeps the flat-function
surface (``tangent_project``, ``retract_polar``, ``project_stiefel``, ``sym``,
``consensus_error``, ``rgd_step``, ...)
that paper-era call sites import.  ``retract`` dispatches through the
registry's Stiefel geometry, so every retraction kind it names (polar, qr,
cayley, polar_fused) is available here.
"""
from __future__ import annotations

import torch

from repro_torch.geometry import STIEFEL
from repro_torch.geometry.stiefel import (  # noqa: F401
    induced_arithmetic_mean,
    invsqrt_spd,
    project_stiefel,
    random_stiefel,
    retract_cayley,
    retract_polar,
    retract_qr,
    stiefel_error,
    tangent_project,
)

Tensor = torch.Tensor


def sym(a: Tensor) -> Tensor:
    """Symmetric part (over the last two dims)."""
    return 0.5 * (a + a.transpose(-1, -2))


def is_tangent(x: Tensor, u: Tensor, atol: float = 1e-5) -> Tensor:
    """Whether u is in T_x M:  x^T u + u^T x = 0."""
    a = torch.einsum("...dr,...ds->...rs", x, u)
    return (a + a.transpose(-1, -2)).abs().max() < atol


def consensus_error(xs: Tensor) -> Tensor:
    """Mean squared distance of the stacked replicas to their IAM (Eq. 10)."""
    xhat = induced_arithmetic_mean(xs)
    return ((xs - xhat) ** 2).sum(dim=(-2, -1)).mean()


def riemannian_grad(x: Tensor, egrad: Tensor) -> Tensor:
    """Riemannian gradient = tangent projection of the Euclidean gradient."""
    return tangent_project(x, egrad)


def rgd_step(x: Tensor, egrad: Tensor, lr: float,
             kind: str = "polar") -> Tensor:
    """Single-node Riemannian gradient-descent step (Eq. 4)."""
    return STIEFEL.retract(x, -lr * tangent_project(x, egrad), kind)


def retract(x: Tensor, u: Tensor, kind: str = "polar", **kw) -> Tensor:
    """R_x(u), dispatched through the registry's Stiefel geometry (kinds:
    polar | qr | cayley | polar_fused)."""
    return STIEFEL.retract(x, u, kind, **kw)
