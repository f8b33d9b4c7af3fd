"""Convergence metric M_t (Eq. 16) and consensus diagnostics.

Mirrors ``src/repro/core/metric.py``:

  M_t = || grad_x F(x_hat_t, y_bar_t) ||
      + (1/n) || x_t - x_hat_t ||
      + (L/n) || y_bar_t - y*(x_hat_t) ||

with x_hat the per-leaf induced arithmetic mean (eigh by default), y_bar
the Euclidean mean and y* the closed-form inner maximizer.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.func import vmap

from repro_torch.core.minimax import MinimaxProblem
from repro_torch.geometry import tangent_project_tree
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor


def consensus_point(problem: MinimaxProblem, x_stacked: dict,
                    method: str = "eigh") -> dict:
    """x_hat: each leaf's induced arithmetic mean over the node axis."""
    return tree_map(lambda m, xs: m.consensus_mean(xs, method=method),
                    problem.manifold_map, x_stacked)


def global_riemannian_grad(problem: MinimaxProblem, x_hat: dict,
                           y_bar: Tensor, batches: Any) -> dict:
    """grad_x F(x_hat, y_bar) = (1/n) sum_i grad_x f_i, Riemannian.
    ``batches`` is node-stacked local data; the params are shared."""
    gx = vmap(lambda b: problem.grads(x_hat, y_bar, b)[0])(batches)
    gx_mean = tree_map(lambda g: g.mean(0), gx)
    return tangent_project_tree(problem.manifold_map, x_hat, gx_mean)


@torch.no_grad()
def convergence_metric(problem: MinimaxProblem, x_stacked: dict,
                       y_stacked: Tensor, batches: Any, L: float = 1.0,
                       method: str = "eigh") -> dict[str, Tensor]:
    """Full M_t (Eq. 16) and its components."""
    n = y_stacked.shape[0]
    x_hat = consensus_point(problem, x_stacked, method)
    y_bar = y_stacked.mean(0)

    g = global_riemannian_grad(problem, x_hat, y_bar, batches)
    grad_norm = torch.sqrt(sum((leaf ** 2).sum() for leaf in tree_leaves(g)))

    cons_x = torch.sqrt(sum(
        ((xs - xh[None]) ** 2).sum()
        for xs, xh in zip(tree_leaves(x_stacked), tree_leaves(x_hat))))

    if problem.y_star is not None:
        y_opt = problem.y_star(x_hat, batches)
        dist_y = torch.linalg.vector_norm(y_bar - y_opt)
    else:
        dist_y = torch.zeros((), device=y_bar.device)

    m_t = grad_norm + cons_x / n + L * dist_y / n
    return {
        "M_t": m_t,
        "grad_norm": grad_norm,
        "consensus_x": cons_x / n,
        "dist_y_star": dist_y,
        "stiefel_residual": _feasibility_residual(problem, x_stacked),
    }


def _feasibility_residual(problem: MinimaxProblem, x_stacked: dict) -> Tensor:
    errs = [m.check(xs).max()
            for m, xs in zip(tree_leaves(problem.manifold_map),
                             tree_leaves(x_stacked))
            if m.name != "euclidean"]
    if not errs:
        return torch.zeros(())
    return torch.stack(errs).max()
