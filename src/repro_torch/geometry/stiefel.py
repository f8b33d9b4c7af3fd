"""Stiefel manifold St(d, r) = {x in R^{d x r} : x^T x = I_r}.

Mirrors ``src/repro/geometry/stiefel.py``:

  * tangent projection  P_{T_x}(g) = g - x sym(x^T g)  (Eq. 3), through
    ``ops.stiefel_project`` (the CUDA kernel on the card), and for all the
    Stiefel leaves of a tree at once ``ops.stiefel_project_leaves`` (one
    launch);
  * polar retraction    R_x(u) = (x + u)(I_r + u^T u)^{-1/2}  (Lemma 1), with
    the inverse square root by Newton--Schulz or eigh;
  * ``polar_fused``: projection + polar retraction of an AMBIENT direction
    in one kernel, ``ops.fused_retract``;
  * QR retraction       qf(x + u) with sign fix;
  * Cayley retraction   (I - W/2)^{-1}(I + W/2) x with the Wen--Yin skew
    W = W_hat - W_hat^T, W_hat = (I - x x^T/2) u x^T, by CG or Neumann
    iterations with W applied in its low-rank form (plain tensor products:
    the JAX package computes it outside any kernel);
  * induced arithmetic mean (IAM)  x_hat = P_St(mean_i x_i)  (Eq. 9).

Every function works on tensors whose last two dims are (d, r); leading
dims broadcast.
"""
from __future__ import annotations

from typing import Literal, Optional

import torch

from repro_torch.geometry.base import Manifold, register
from repro_torch.kernels import ops
from repro_torch.kernels.ref import chunked_sum, invsqrt_newton_schulz

Tensor = torch.Tensor


def tangent_project(x: Tensor, g: Tensor) -> Tensor:
    """Orthogonal projection of ambient ``g`` onto T_x St(d, r)  (Eq. 3)."""
    return ops.stiefel_project(x, g)


def stiefel_error(x: Tensor) -> Tensor:
    """|| x^T x - I ||_F  (feasibility residual)."""
    r = x.shape[-1]
    xtx = torch.einsum("...dr,...ds->...rs", x, x)
    eye = torch.eye(r, dtype=x.dtype, device=x.device)
    return torch.linalg.matrix_norm(xtx - eye)


def _invsqrt_eigh(a: Tensor) -> Tensor:
    """Inverse square root of an SPD matrix via eigh."""
    w, v = torch.linalg.eigh(a)
    w = w.clamp_min(1e-12)
    return torch.einsum("...ir,...r,...jr->...ij", v, torch.rsqrt(w), v)


def invsqrt_spd(a: Tensor, method: Literal["ns", "eigh"] = "ns") -> Tensor:
    if method == "eigh":
        return _invsqrt_eigh(a)
    return invsqrt_newton_schulz(a)


def _gram(a: Tensor) -> Tensor:
    """a^T a over the last two dims, its reduction over d in chunks above
    ``ref.LONG_K``."""
    return chunked_sum(lambda s: torch.einsum("...dr,...ds->...rs",
                                              a[..., s, :], a[..., s, :]),
                       a.shape[-2])


def _apply(a: Tensor, m: Tensor) -> Tensor:
    """a @ m for a (..., d, r) and m (..., r, s), its reduction over r in
    chunks above ``ref.LONG_K``."""
    return chunked_sum(lambda s: torch.einsum("...dr,...rs->...ds",
                                              a[..., s], m[..., s, :]),
                       a.shape[-1])


def retract_polar(x: Tensor, u: Tensor,
                  method: Literal["ns", "eigh"] = "ns") -> Tensor:
    """Polar retraction R_x(u) = (x+u)(I + u^T u)^{-1/2} (Lemma 1), valid
    for u in T_x M.  Reductions above ``ref.LONG_K`` are summed in chunks
    (``ref.chunked_sum``: on a card, whole fp32 reductions at k = 2048
    leave the result several times less orthonormal than the CPU's)."""
    r = u.shape[-1]
    a = torch.eye(r, dtype=u.dtype, device=u.device) + _gram(u)
    return _apply(x + u, invsqrt_spd(a, method))


def retract_qr(x: Tensor, u: Tensor) -> Tensor:
    """QR retraction: qf(x + u) with sign fix so R_x(0) = x."""
    q, rr = torch.linalg.qr(x + u)
    d = torch.sign(torch.diagonal(rr, dim1=-2, dim2=-1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    return q * d[..., None, :]


def retract_cayley(x: Tensor, u: Tensor, iters: int = 12,
                   solver: Literal["cg", "neumann"] = "cg") -> Tensor:
    """Cayley retraction (Wen & Yin 2013), the JAX package's
    ``retract_cayley``:

        R_x(u) = (I - W/2)^{-1} (I + W/2) x,
        W = W_hat - W_hat^T,   W_hat = (I - x x^T / 2) u x^T.

    W is skew, so R_x(u) lands on St(d, r) for any ``u``.  W is never
    formed: it is applied through (r, r) intermediates.

    * ``solver="cg"``: CG on the normal equations
      (I - W^2/4) z = (I + W + W^2/4) x, whose operator is SPD, with the
      reference's guarded divisions (converged batch elements stay fixed);
    * ``solver="neumann"``: the fixed point z <- (I + W/2) x + (W/2) z,
      which converges for ||W|| < 2.
    """
    xtu = torch.einsum("...dr,...ds->...rs", x, u)

    def wv(v: Tensor) -> Tensor:
        # W v = u (x^T v) - x [ u^T v + 0.5 (x^T u)(x^T v)
        #                               - 0.5 (x^T u)^T (x^T v) ]
        xtv = torch.einsum("...dr,...ds->...rs", x, v)
        utv = torch.einsum("...dr,...ds->...rs", u, v)
        inner = utv + 0.5 * (torch.einsum("...rs,...st->...rt", xtu, xtv)
                             - torch.einsum("...sr,...st->...rt", xtu, xtv))
        return (torch.einsum("...dr,...rs->...ds", u, xtv)
                - torch.einsum("...dr,...rs->...ds", x, inner))

    if solver == "neumann":
        b = x + 0.5 * wv(x)
        z = b
        for _ in range(iters):
            z = b + 0.5 * wv(z)
        return z

    def a_op(v: Tensor) -> Tensor:               # (I - W^2/4) v, SPD
        return v - 0.25 * wv(wv(v))

    def dot(a: Tensor, b: Tensor) -> Tensor:
        return (a * b).sum(dim=(-2, -1), keepdim=True)

    wx = wv(x)
    rhs = x + wx + 0.25 * wv(wx)                 # (I + W + W^2/4) x
    z = x                                        # z ~ x for small steps
    r = rhs - a_op(z)
    p = r
    rr = dot(r, r)
    for _ in range(iters):
        ap = a_op(p)
        alpha = rr / dot(p, ap).clamp_min(1e-30)
        z = z + alpha * p
        r = r - alpha * ap
        rr_new = dot(r, r)
        beta = rr_new / rr.clamp_min(1e-30)
        p = r + beta * p
        rr = rr_new
    return z


def project_stiefel(a: Tensor, method: Literal["ns", "eigh"] = "ns") -> Tensor:
    """P_St(a): the polar factor of ``a`` (full column rank), a (a^T a)^{-1/2},
    its long reductions in chunks as :func:`retract_polar`'s."""
    return _apply(a, invsqrt_spd(_gram(a), method))


def induced_arithmetic_mean(xs: Tensor,
                            method: Literal["ns", "eigh"] = "ns") -> Tensor:
    """IAM over the leading axis (Eq. 9): P_St( (1/n) sum_i x_i )."""
    return project_stiefel(xs.mean(0), method)


def random_stiefel(d: int, r: int, batch: tuple[int, ...] = (), *,
                   generator: torch.Generator, device) -> Tensor:
    a = torch.randn((*batch, d, r), generator=generator)
    return torch.linalg.qr(a)[0].to(device)


class Stiefel(Manifold):
    """St(d, r) over the last two dims; the paper's default geometry."""

    name = "stiefel"
    retractions = ("polar", "qr", "cayley", "polar_fused")
    default_retraction = "polar"
    fused_retraction = "polar_fused"
    requires_tall = True

    def tangent_project(self, x: Tensor, g: Tensor) -> Tensor:
        return tangent_project(x, g)

    def tangent_project_leaves(self, xs: list[Tensor],
                               gs: list[Tensor]) -> list[Tensor]:
        return ops.stiefel_project_leaves(xs, gs)

    def retract(self, x: Tensor, u: Tensor, kind: Optional[str] = None,
                *, method: str = "ns", iters: Optional[int] = None,
                solver: str = "cg", **kw) -> Tensor:
        kind = kind or self.default_retraction
        if kind == "polar":
            return retract_polar(x, u, method=method)
        if kind == "qr":
            return retract_qr(x, u)
        if kind == "cayley":
            return retract_cayley(x, u, solver=solver,
                                  **({"iters": iters} if iters else {}))
        if kind == "polar_fused":
            # ``u`` is the AMBIENT update direction; the kernel projects it
            return ops.fused_retract(x, u, **kw)
        raise ValueError(f"unknown retraction {kind!r}")

    def project(self, a: Tensor, method: str = "ns") -> Tensor:
        return project_stiefel(a, method)

    def dist(self, x: Tensor, y: Tensor) -> Tensor:
        """Extrinsic (embedded-Frobenius) distance."""
        return torch.linalg.matrix_norm(x - y)

    def rand(self, d: int, r: int, batch: tuple[int, ...] = (), *,
             generator: torch.Generator, device) -> Tensor:
        return random_stiefel(d, r, batch, generator=generator, device=device)

    def check(self, x: Tensor) -> Tensor:
        return stiefel_error(x)

    def feasible_init(self, x: Tensor) -> Tensor:
        # QR orthonormalization: exact feasibility whatever the initializer
        return retract_qr(torch.zeros_like(x), x)


STIEFEL = register(Stiefel())
