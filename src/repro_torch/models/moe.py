"""Mixture-of-Experts FFN of the port (``src/repro/models/moe.py``): top-k
routing, capacity-bounded sort-based dispatch, and shared experts.

Dispatch is the JAX package's gather/scatter formulation: the (token,
choice) pairs are sorted by expert (stable), each expert keeps its first
``cap`` of them, and the kept tokens are gathered into an (E, cap, d)
block that the stacked expert weights multiply as batched GEMMs.  Where
JAX writes with ``mode="drop"``, the port gives the overflow slot
``e * cap`` a real row of the (E * cap + 1) buffers and cuts it off
afterwards, as the JAX code does with its dump bin; dropped pairs land
there and add nothing.  Capacity is per dispatch group
(``MoESpec.dispatch_groups``): the JAX package ``vmap``s the groups, the
port loops over them.  The expert products are plain GEMMs, outside any
Pallas kernel in the JAX package too.  The router is Euclidean and its
logits are fp32.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, MoESpec
from repro_torch.models.layers import dense_init, draw_device

Tensor = torch.Tensor


def init_moe(generator: torch.Generator, cfg: ModelConfig, spec: MoESpec,
             dtype=torch.float32) -> dict:
    """Router N(0, 0.02^2) in fp32; expert weights (E, d, f) and (E, f, d)
    at N(0, 1/d_in), as the JAX initializer scales them."""
    d, e = cfg.d_model, spec.n_experts
    f = spec.d_expert or cfg.d_ff
    dev = draw_device(generator)

    def experts(d_in, d_out):
        return ((1.0 / d_in) ** 0.5 * torch.randn(
            (e, d_in, d_out), generator=generator, device=dev)).to(dtype)

    p = {"router": dense_init(generator, d, e, scale=0.02,
                              dtype=torch.float32),
         "w_gate": experts(d, f), "w_up": experts(d, f),
         "w_down": experts(f, d)}
    if spec.n_shared:
        fs = f * spec.n_shared
        p["shared"] = {"w_gate": dense_init(generator, d, fs, dtype=dtype),
                       "w_up": dense_init(generator, d, fs, dtype=dtype),
                       "w_down": dense_init(generator, fs, d, dtype=dtype)}
    return p


def apply_moe(params: dict, x: Tensor, spec: MoESpec) -> tuple[Tensor,
                                                                Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  With ``dispatch_groups`` G > 1
    dividing B * S (-1: G = B) the tokens are dispatched in G contiguous
    groups, each with its own capacity, and aux is the groups' mean."""
    b, s, d = x.shape
    t = b * s
    g = b if spec.dispatch_groups == -1 else spec.dispatch_groups
    if g > 1 and t % g == 0:
        outs = [_dispatch_one(params, xg, spec)
                for xg in x.reshape(g, t // g, d)]
        y = torch.stack([o[0] for o in outs]).reshape(b, s, d)
        return y.to(x.dtype), torch.stack([o[1] for o in outs]).mean()
    y, aux = _dispatch_one(params, x.reshape(t, d), spec)
    return y.reshape(b, s, d).to(x.dtype), aux


def route(params: dict, xf: Tensor, spec: MoESpec):
    """Router of a flat (T, d) group: (probs (T, E), renormalized gates
    (T, K), chosen experts (T, K), in descending probability)."""
    probs = torch.softmax(xf.float() @ params["router"], dim=-1)
    gate_vals, expert_idx = torch.topk(probs, spec.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, expert_idx


def capacity(t: int, spec: MoESpec) -> int:
    """Slots per expert for a group of ``t`` tokens (Python's ``round``,
    as the JAX package computes it)."""
    k = spec.top_k
    return int(max(k, round(t * k / spec.n_experts * spec.capacity_factor)))


def _dispatch_one(params: dict, xf: Tensor, spec: MoESpec) -> tuple[Tensor,
                                                                     Tensor]:
    """Sort-based capacity dispatch of a flat (T, d) token group."""
    t, d = xf.shape
    e, k = spec.n_experts, spec.top_k
    dev = xf.device
    probs, gate_vals, expert_idx = route(params, xf, spec)

    # load-balance auxiliary loss (Switch-style)
    counts = torch.zeros((t, e), dtype=torch.float32, device=dev)
    counts.scatter_add_(1, expert_idx, torch.ones_like(gate_vals))
    aux = e * torch.sum(counts.mean(0) * probs.mean(0)) \
        * spec.router_aux_coef

    # sort-based capacity dispatch
    cap = capacity(t, spec)
    flat_expert = expert_idx.reshape(-1)                          # (T*K,)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)
    se, sg, st_ = (flat_expert[order], gate_vals.reshape(-1)[order],
                   flat_token[order])
    seg_start = torch.searchsorted(se, torch.arange(e, device=dev),
                                   right=False)                   # (E,)
    pos_in_e = torch.arange(t * k, device=dev) - seg_start[se]
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e,
                       torch.full_like(se, e * cap))              # overflow

    # token index per (expert, capacity) slot; e*cap is the dump row
    token_buf = torch.full((e * cap + 1,), t, dtype=torch.long, device=dev)
    token_buf[slot] = st_
    gate_buf = torch.zeros((e * cap + 1,), dtype=torch.float32, device=dev)
    gate_buf[slot] = torch.where(keep, sg, torch.zeros_like(sg))
    token_buf = token_buf[:e * cap].reshape(e, cap)
    gate_buf = gate_buf[:e * cap].reshape(e, cap)

    xpad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    xe = xpad[token_buf]                                          # (E, C, d)
    h = torch.nn.functional.silu(torch.bmm(xe, params["w_gate"])) \
        * torch.bmm(xe, params["w_up"])
    ye = torch.bmm(h, params["w_down"])                           # (E, C, d)
    ye = ye * gate_buf[..., None].to(ye.dtype)

    y = ye.new_zeros((t + 1, d)).index_add_(
        0, token_buf.reshape(-1), ye.reshape(-1, d))[:t]

    if "shared" in params:
        sh = params["shared"]
        hs = torch.nn.functional.silu(xf @ sh["w_gate"]) * (xf @ sh["w_up"])
        y = y + hs @ sh["w_down"]
    return y, aux
