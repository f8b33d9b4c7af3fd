"""Orthonormal fair classification (paper Eqs. 19-20) and distributionally
robust optimization (Eq. 21) on a small CNN: the paper's own experiments.

Mirrors ``src/repro/objectives/fair.py``:

    min_{w in St}  max_{u in Delta_3}  sum_i u_i L_i(w) - rho ||u||^2   (fair)
    min_{w in St}  max_{p in Delta_G}  sum_g p_g l_g(w) - ||p - 1/G||^2 (DRO)

conv-conv-fc-fc; the fully connected weights are Stiefel leaves, the conv
kernels Euclidean.  Images come NHWC as in the JAX package and are
transposed inside :func:`cnn_forward`; conv kernels are kept in PyTorch's
OIHW layout (``convert.py`` maps the JAX package's HWIO kernels).  The
flattened features keep the JAX package's (H, W, C) order, so ``fc1`` is
the same matrix in both packages.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core.minimax import MinimaxProblem, project_simplex
from repro_torch.models.layers import orthogonal_init

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# small CNN
# ---------------------------------------------------------------------------


def init_cnn(generator: torch.Generator, image_hw: int = 14,
             channels: int = 1, n_classes: int = 3, c1: int = 8,
             c2: int = 16, fc: int = 64, *, device) -> dict:
    flat = (image_hw // 4) * (image_hw // 4) * c2
    params = {
        "conv1": torch.randn((c1, channels, 3, 3), generator=generator) * 0.2,
        "conv2": torch.randn((c2, c1, 3, 3), generator=generator) * 0.1,
        "fc1": orthogonal_init(generator, flat, fc),         # Stiefel leaf
        "head": orthogonal_init(generator, fc, n_classes),   # Stiefel leaf
    }
    return {k: v.to(device) for k, v in params.items()}


def cnn_manifold_map(params: dict) -> dict:
    return {"conv1": "euclidean", "conv2": "euclidean",
            "fc1": "stiefel", "head": "stiefel"}


def cnn_forward(params: dict, images: Tensor) -> Tensor:
    """images (B, H, W, C) -> logits (B, n_classes)."""
    x = images.permute(0, 3, 1, 2)
    for w in (params["conv1"], params["conv2"]):
        x = F.conv2d(x, w, padding=1)          # 3x3 "SAME"
        x = F.max_pool2d(F.relu(x), 2)         # 2x2, stride 2, "VALID"
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = torch.tanh(x @ params["fc1"])
    return x @ params["head"]


def _per_class_ce(logits: Tensor, labels: Tensor, n_classes: int) -> Tensor:
    lp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(lp, -1, labels[:, None])[:, 0]
    classes = torch.arange(n_classes, device=labels.device)
    oh = (labels[:, None] == classes).to(logits.dtype)
    counts = oh.sum(0)
    sums = (nll[:, None] * oh).sum(0)
    return torch.where(counts > 0, sums / counts.clamp_min(1.0), nll.mean())


def _node_class_losses(params: dict, batches: dict, n_classes: int) -> Tensor:
    """Per-class losses of every node's batch at shared params, (n, C)."""
    images = batches["images"]
    n, b = images.shape[:2]
    logits = cnn_forward(params, images.reshape(n * b, *images.shape[2:]))
    logits = logits.reshape(n, b, -1)
    return torch.stack([_per_class_ce(logits[i], batches["labels"][i],
                                      n_classes) for i in range(n)])


# ---------------------------------------------------------------------------
# Eq. 19/20: fair classification over class losses
# ---------------------------------------------------------------------------


def fair_loss(params: dict, u: Tensor, batch: dict, *, n_classes: int,
              rho: float) -> Tensor:
    logits = cnn_forward(params, batch["images"])
    lc = _per_class_ce(logits, batch["labels"], n_classes)
    return torch.dot(u, lc) - rho * (u ** 2).sum()


def fair_y_star(params: dict, batches: dict, *, n_classes: int,
                rho: float) -> Tensor:
    lc = _node_class_losses(params, batches, n_classes).mean(0)
    # max_u  u.l - rho||u||^2  over the simplex  =  proj( l / (2 rho) )
    return project_simplex(lc / (2.0 * rho))


def make_fair_problem(params_template: dict, n_classes: int = 3,
                      rho: float = 1.0) -> MinimaxProblem:
    return MinimaxProblem(
        loss_fn=functools.partial(fair_loss, n_classes=n_classes, rho=rho),
        project_y=project_simplex,
        manifold_map=cnn_manifold_map(params_template),
        y_star=functools.partial(fair_y_star, n_classes=n_classes, rho=rho),
        name="fair-classification",
    )


# ---------------------------------------------------------------------------
# Eq. 21: DRO over group weights
# ---------------------------------------------------------------------------


def dro_loss(params: dict, p: Tensor, batch: dict, *, n_groups: int) -> Tensor:
    logits = cnn_forward(params, batch["images"])
    # groups == class labels in the classification stream
    lg = _per_class_ce(logits, batch["labels"], n_groups)
    return torch.dot(p, lg) - ((p - 1.0 / n_groups) ** 2).sum()


def dro_y_star(params: dict, batches: dict, *, n_groups: int) -> Tensor:
    lg = _node_class_losses(params, batches, n_groups).mean(0)
    return project_simplex(1.0 / n_groups + lg / 2.0)


def make_dro_problem(params_template: dict, n_groups: int = 3) -> MinimaxProblem:
    return MinimaxProblem(
        loss_fn=functools.partial(dro_loss, n_groups=n_groups),
        project_y=project_simplex,
        manifold_map=cnn_manifold_map(params_template),
        y_star=functools.partial(dro_y_star, n_groups=n_groups),
        name="dro-classification",
    )
