"""Robust PCA on the Grassmann manifold: a subspace minimax workload.

Mirrors ``src/repro/objectives/robust_pca.py``:

    min_{x in Gr(d,r)}  max_{y in simplex_m}
        sum_j y_j * res_j(x)  -  rho * ||y - 1/m||^2,
    res_j(x) = || z_j - x x^T z_j ||^2 / ||z_j||^2   (relative residual)

The adversary up-weights the samples the current subspace reconstructs
worst.  The exact inner maximizer is closed form,
``y*(x) = proj_simplex(1/m + res(x) / (2 rho))``, which feeds M_t (Eq. 16).
Each node holds ``m`` samples (rows of ``batch["z"]``).

:func:`make_batches` draws from a seeded ``torch.Generator``; it cannot
reproduce the JAX package's ``jax.random`` draws, so runs that must match
the JAX package take its arrays instead.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.func import vmap

from repro_torch.core.minimax import MinimaxProblem, project_simplex

Tensor = torch.Tensor


def residuals(x: Tensor, z: Tensor) -> Tensor:
    """Per-sample relative reconstruction residual
    ``||z_j - x x^T z_j||^2 / ||z_j||^2`` in [0, 1], for orthonormal ``x``
    (d, r) and samples ``z`` (m, d); invariant to the basis of span(x)."""
    proj = torch.einsum("md,dr->mr", z, x)        # coordinates in the basis
    recon = torch.einsum("mr,dr->md", proj, x)
    nrm = (z * z).sum(dim=-1).clamp_min(1e-12)
    return ((z - recon) ** 2).sum(dim=-1) / nrm


def robust_pca_loss(x: dict, y: Tensor, batch: dict, *, rho: float) -> Tensor:
    res = residuals(x["w"], batch["z"])
    m = res.shape[-1]
    return torch.dot(y, res) - rho * ((y - 1.0 / m) ** 2).sum()


def robust_pca_y_star(x: dict, batches: dict, *, rho: float) -> Tensor:
    """Exact inner maximizer of the *global* objective at shared params
    (node-stacked batches)."""
    res = vmap(lambda z: residuals(x["w"], z))(batches["z"]).mean(0)
    m = res.shape[-1]
    return project_simplex(1.0 / m + res / (2.0 * rho))


def make_robust_pca_problem(rho: float = 0.1) -> MinimaxProblem:
    return MinimaxProblem(
        loss_fn=functools.partial(robust_pca_loss, rho=rho),
        project_y=project_simplex,
        manifold_map={"w": "grassmann"},
        y_star=functools.partial(robust_pca_y_star, rho=rho),
        name="robust-pca",
    )


def make_batches(generator: torch.Generator, n_nodes: int, m: int, d: int,
                 r: int, noise: float = 0.05, outlier_frac: float = 0.15,
                 outlier_scale: float = 3.0,
                 subspace: Optional[Tensor] = None, *,
                 device="cpu") -> tuple[dict, Tensor]:
    """Node-heterogeneous spiked-subspace samples with outliers.

    Returns (batches, basis): ``batches["z"]`` is (n_nodes, m, d); clean
    rows are ``coeff @ basis^T`` plus ``noise`` times standard normal noise
    (``basis`` a random (d, r) orthonormal basis unless ``subspace`` is
    given), and each row is, with probability ``outlier_frac``, replaced by
    ``outlier_scale`` times standard normal noise.  Drawn on the CPU from
    ``generator`` and moved to ``device``.
    """
    if subspace is None:
        subspace = torch.linalg.qr(torch.randn((d, r),
                                               generator=generator))[0]
    subspace = subspace.cpu()
    coeff = torch.randn((n_nodes, m, r), generator=generator)
    clean = torch.einsum("nmr,dr->nmd", coeff, subspace)
    clean = clean + noise * torch.randn((n_nodes, m, d), generator=generator)
    outliers = outlier_scale * torch.randn((n_nodes, m, d),
                                           generator=generator)
    is_out = torch.rand((n_nodes, m, 1), generator=generator) < outlier_frac
    z = torch.where(is_out, outliers, clean)
    return {"z": z.to(device)}, subspace.to(device)


def init_y(n_nodes: int, m: int, device="cpu") -> Tensor:
    return torch.full((n_nodes, m), 1.0 / m, device=device)
