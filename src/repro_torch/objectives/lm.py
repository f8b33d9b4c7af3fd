"""Group-DRO language-model objective: the paper's Eq. (21) form applied to
LM pretraining.  Mirrors ``src/repro/objectives/lm.py``:

    min_{theta, St-leaves on St(d,r)}  max_{y in simplex_G}
        sum_g y_g * L_g(theta)  -  rho * ||y - 1/G||^2   (+ MoE aux loss)

strongly concave in y (coefficient rho), with the exact inner maximizer
y*(theta) = proj_simplex(1/G + L(theta) / (2 rho)) in closed form for the
convergence metric M_t.  The optimizers batch :func:`lm_minimax_loss` over
the node axis with ``torch.func.vmap``; the attention inside goes through
``kernels.ops.flash_attention``, whose ``vmap`` rule folds the node axis
into the batch.  Tokens and group ids are integer tensors (int64 is
PyTorch's index type); tokens are (B, S), or (B, S, CB) with codebooks,
whose targets are ``tokens[..., 1:, :]`` (``token_ce`` averages over S and
CB).  A batch of a model with a frontend also carries
``frontend_embeds`` (B, n_tokens, embed_dim) float32, which the forward
reads.  Every architecture the port serves trains: MoE blocks (their
router's auxiliary loss added to the robust loss), codebooks, MLA and
cross-attention.
"""
from __future__ import annotations

import functools
import re

import torch
from torch.func import vmap

from repro_torch.configs.base import ModelConfig
from repro_torch.core.minimax import MinimaxProblem, project_simplex
from repro_torch.geometry import manifold_map_from_paths
from repro_torch.models import transformer as T

Tensor = torch.Tensor


def _one_hot(idx: Tensor, n: int) -> Tensor:
    """float32 one-hot of an integer tensor along a new last axis (a
    comparison, which ``vmap`` batches)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def token_ce(logits: Tensor, targets: Tensor, impl: str = "gather",
             true_vocab: int = 0) -> Tensor:
    """Per-sequence mean CE.  logits (B, S, V) or (B, S, CB, V); targets
    (B, S) or (B, S, CB) integer; the mean runs over S (and CB).

    ``impl="dot"`` takes the correct-class logit as a one-hot contraction
    over the vocab axis (the JAX package's §Perf knob for a model-sharded
    vocab); ``"gather"`` indexes it.  Padded unembedding rows past
    ``true_vocab`` are left out of the softmax."""
    lf = logits.float()
    v = lf.shape[-1]
    if true_vocab and v > true_vocab:
        mask = torch.arange(v, device=lf.device) < true_vocab
        lf = torch.where(mask, lf, torch.full_like(lf, -1e30))
    if impl == "dot":
        m = lf.amax(dim=-1, keepdim=True).detach()
        lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
        correct = (lf * _one_hot(targets, v)).sum(dim=-1)
        nll = lse - correct
    else:
        lp = torch.log_softmax(lf, dim=-1)
        nll = -torch.gather(lp, -1, targets.long()[..., None])[..., 0]
    return nll.mean(dim=tuple(range(1, nll.ndim)))              # (B,)


def group_losses(per_seq_loss: Tensor, group_ids: Tensor,
                 n_groups: int) -> Tensor:
    """Mean loss per group; groups absent from the batch get the batch mean
    (so they neither attract nor repel the adversary)."""
    oh = _one_hot(group_ids, n_groups)                           # (B, G)
    counts = oh.sum(0)
    sums = (per_seq_loss[:, None] * oh).sum(0)
    mean_all = per_seq_loss.mean()
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                       mean_all)


def _group_losses_of(params: dict, batch: dict, cfg: ModelConfig):
    tokens = batch["tokens"]
    logits, aux, _ = T.forward(params, cfg, tokens[:, :-1],
                               frontend_embeds=batch.get("frontend_embeds"),
                               mode="train")
    per_seq = token_ce(logits, tokens[:, 1:], impl=cfg.ce_impl,
                       true_vocab=cfg.vocab_size)
    return group_losses(per_seq, batch["group_ids"], cfg.n_groups), aux


def lm_minimax_loss(params: dict, y: Tensor, batch: dict,
                    cfg: ModelConfig) -> Tensor:
    """f_i(x, y) of one node: ``batch`` holds its tokens (B, S) (or
    (B, S, CB)), group ids (B,) and, with a frontend, its embeddings."""
    lg, aux = _group_losses_of(params, batch, cfg)
    robust = torch.dot(y, lg) - cfg.rho * torch.sum(
        (y - 1.0 / cfg.n_groups) ** 2)
    return robust + aux


def lm_y_star(params: dict, batches: dict, cfg: ModelConfig) -> Tensor:
    """Exact global inner maximizer at shared params (node-stacked batch)."""
    lg = vmap(lambda b: _group_losses_of(params, b, cfg)[0])(batches)
    return project_simplex(1.0 / cfg.n_groups
                           + lg.mean(0) / (2.0 * cfg.rho))


def make_lm_problem(cfg: ModelConfig, params_template: dict
                    ) -> MinimaxProblem:
    """The group-DRO problem of ``cfg``: the leaves whose '/'-joined path
    matches ``cfg.manifold_policy`` live on ``cfg.manifold`` (shapes from
    ``params_template``; see ``models.transformer.abstract_params``)."""
    pattern = re.compile(cfg.manifold_policy)
    mmap = manifold_map_from_paths(
        params_template, lambda path: bool(pattern.search(path)),
        manifold=cfg.manifold)
    return MinimaxProblem(
        loss_fn=functools.partial(lm_minimax_loss, cfg=cfg),
        project_y=project_simplex,
        manifold_map=mmap,
        y_star=functools.partial(lm_y_star, cfg=cfg),
        name=f"group-dro-lm/{cfg.name}",
    )


def init_y(cfg: ModelConfig, n_nodes: int, device=None) -> Tensor:
    return torch.full((n_nodes, cfg.n_groups), 1.0 / cfg.n_groups,
                      dtype=torch.float32, device=device)
