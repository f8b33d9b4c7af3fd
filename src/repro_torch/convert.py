"""Carry weights and data between the JAX package's layout and the port's.

The JAX package keeps parameters as dicts of arrays with conv kernels in
HWIO; the port keeps conv kernels in PyTorch's OIHW.  Node-stacked trees
carry the node axis first in both.  Everything else (Stiefel leaves, y,
batches) has the same layout in both packages.  The transformer's nested
parameter dicts (MLA's projections, cross-attention's ``wk_x``, ``wv_x``,
``ln_x`` and the frontend's ``frontend_proj`` among them), its KV caches
(MLA's compressed ``{c_kv, k_rope, pos}`` too) and the serving path's page
pools copy leaf for leaf (weights ``x @ W`` as (d_in, d_out), stacked
repeats on a leading axis, in both).  The comms engine's memory
(``CommState`` hats, one tree per slot) converts the same way.  Inputs are
NumPy arrays (or anything ``numpy.asarray`` takes); this module imports no
JAX.  :func:`lm_params_from_seed` draws a transformer's parameters, and
:func:`lm_frontend_from_seed` a batch's frontend embeddings, with NumPy
alone, so that a JAX run and a run of the port can start from the same
weights and data without carrying them in a file.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comms.layer import CommState

# HWIO -> OIHW for one kernel, and with a leading node axis
_TO_OIHW = {4: (3, 2, 0, 1), 5: (0, 4, 3, 1, 2)}
_TO_HWIO = {4: (2, 3, 1, 0), 5: (0, 3, 4, 2, 1)}


def _is_conv(name: str) -> bool:
    return name.startswith("conv")


def params_from_reference(params: dict, device) -> dict:
    """The JAX package's parameter dict (single-node or node-stacked) as
    the port's tensors: conv kernels HWIO -> OIHW, fp32."""
    out = {}
    for name, value in params.items():
        a = np.array(value, dtype=np.float32)
        if _is_conv(name):
            a = np.transpose(a, _TO_OIHW[a.ndim])
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def params_to_reference(params: dict) -> dict:
    """The inverse of :func:`params_from_reference`, as NumPy arrays."""
    out = {}
    for name, value in params.items():
        a = value.detach().cpu().numpy()
        if _is_conv(name):
            a = np.transpose(a, _TO_HWIO[a.ndim])
        out[name] = np.ascontiguousarray(a)
    return out


def _slot_from_reference(tree, device):
    if isinstance(tree, dict):
        return params_from_reference(tree, device)
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def _slot_to_reference(tree):
    if isinstance(tree, dict):
        return params_to_reference(tree)
    return tree.detach().cpu().numpy()


def comm_state_from_reference(hats: dict, deltas: dict | None, device):
    """The JAX package's ``CommState`` memory (its ``hats`` and ``deltas``,
    as NumPy) as the port's ``CommState``: per slot (x, y, u, v) a parameter
    dict, conv kernels HWIO -> OIHW, or a plain array."""
    return CommState(
        hats={slot: _slot_from_reference(tree, device)
              for slot, tree in hats.items()},
        deltas=None if deltas is None else {
            slot: torch.tensor(float(np.asarray(d)), dtype=torch.float32,
                               device=device)
            for slot, d in deltas.items()})


def comm_state_to_reference(state) -> tuple[dict, dict | None]:
    """The inverse of :func:`comm_state_from_reference`: (hats, deltas) as
    NumPy arrays in the JAX package's layout."""
    hats = {slot: _slot_to_reference(tree) for slot, tree in state.hats.items()}
    deltas = None if state.deltas is None else {
        slot: np.float32(d.item()) for slot, d in state.deltas.items()}
    return hats, deltas


def tree_from_reference(tree, device, dtype=None):
    """A nested dict of the JAX package's arrays (parameters, caches,
    pools) as tensors on ``device``, copied leaf for leaf, in ``dtype``
    (a NumPy dtype; default: each leaf's own)."""
    if isinstance(tree, dict):
        return {k: tree_from_reference(v, device, dtype)
                for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=dtype)).to(device)


def tree_to_reference(tree):
    """The inverse of :func:`tree_from_reference`, as NumPy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_reference(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def transformer_params_from_reference(params: dict, device) -> dict:
    """The JAX transformer's parameters (``models.transformer.init_params``,
    stacked repeats, MoE experts and routers, codebook stacks included) as
    the port's fp32 tensors, leaf for leaf, no transpose."""
    return tree_from_reference(params, device, np.float32)


def transformer_params_to_reference(params: dict) -> dict:
    """The inverse of :func:`transformer_params_from_reference`."""
    return tree_to_reference(params)


def batch_to_torch(batch: dict, device) -> dict:
    """A synthetic-stream batch (images fp32, labels int) as tensors; labels
    become int64, the index type of PyTorch's gather."""
    return {
        "images": torch.as_tensor(np.asarray(batch["images"], np.float32),
                                  device=device),
        "labels": torch.as_tensor(np.asarray(batch["labels"], np.int64),
                                  device=device),
    }


def lm_batch_to_torch(batch: dict, device) -> dict:
    """A ``TokenStream`` batch (tokens, group ids; int32) as int64 tensors,
    PyTorch's index type; ``frontend_embeds``, where the batch has them,
    as float32."""
    return {k: torch.as_tensor(np.asarray(
                v, np.float32 if k == "frontend_embeds" else np.int64),
                device=device)
            for k, v in batch.items()}


def lm_params_from_seed(cfg, seed: int) -> dict:
    """One node's transformer parameters (``"attn"`` and ``"moe_attn"``
    blocks with GQA or MLA attention and cross-attention sublayers,
    ``"mamba"`` blocks, one token stream or ``n_codebooks``, a frontend
    projection) in the JAX package's layout, as float32 NumPy arrays drawn
    from ``numpy.random.default_rng(seed)``, each leaf at its JAX
    initializer's scale (``src/repro/models/layers.py``, ``attention.py``,
    ``moe.py``, ``ssm.py``): embeddings N(0, 0.02^2), dense weights (MLA's
    down projections, ``frontend_proj`` and Mamba2's ``in_proj`` and
    ``out_proj`` among them) and expert weights N(0, 1/d_in), Mamba2's
    causal conv N(0, 1/width), its ``a_log`` ``log(linspace(1, 16, H))``,
    ``d_skip`` ones and ``dt_bias`` zeros, the MoE router N(0, 0.02^2),
    attention projections (MLA's up projections, the
    cross-attention's ``wk_x``, ``wv_x``) orthonormal (the Q factor of a
    Gaussian, transposed for a wide matrix), norm scales ones; stacked
    repeats on a leading axis, codebooks on a leading (CB, ...) axis.  Not
    the JAX package's draws (those come from ``jax.random``): both
    packages take these instead."""
    rng = np.random.default_rng(seed)
    d, hd, v, cb = cfg.d_model, cfg.hd, cfg.padded_vocab, cfg.n_codebooks

    def normal(shape, scale):
        return (scale * rng.standard_normal(shape, dtype=np.float32)
                ).astype(np.float32)

    def orthogonal(d_in, d_out):
        tall = d_in >= d_out
        a = rng.standard_normal((d_in, d_out) if tall else (d_out, d_in))
        q = np.linalg.qr(a)[0]
        return np.ascontiguousarray(q if tall else q.T, dtype=np.float32)

    def moe(spec):
        e, f = spec.n_experts, spec.d_expert or cfg.d_ff
        p = {"router": normal((d, e), 0.02),
             "w_gate": normal((e, d, f), d ** -0.5),
             "w_up": normal((e, d, f), d ** -0.5),
             "w_down": normal((e, f, d), f ** -0.5)}
        if spec.n_shared:
            fs = f * spec.n_shared
            p["shared"] = {"w_gate": normal((d, fs), d ** -0.5),
                           "w_up": normal((d, fs), d ** -0.5),
                           "w_down": normal((fs, d), fs ** -0.5)}
        return p

    def mla(a):
        h = cfg.n_heads
        dn, dr = a.qk_nope_head_dim, a.qk_rope_head_dim
        p = {}
        if a.q_lora_rank:
            p["w_dq"] = normal((d, a.q_lora_rank), d ** -0.5)
        p["w_dkv"] = normal((d, a.kv_lora_rank + dr), d ** -0.5)
        p["w_uk"] = orthogonal(a.kv_lora_rank, h * dn)
        p["w_uv"] = orthogonal(a.kv_lora_rank, h * a.v_head_dim)
        p["wo"] = orthogonal(h * a.v_head_dim, d)
        p["w_uq"] = orthogonal(a.q_lora_rank or d, h * (dn + dr))
        return p

    def gqa(a):
        p = {"wq": orthogonal(d, cfg.n_heads * hd),
             "wk": orthogonal(d, cfg.n_kv_heads * hd),
             "wv": orthogonal(d, cfg.n_kv_heads * hd),
             "wo": orthogonal(cfg.n_heads * hd, d)}
        if a.cross_attn:
            p["wk_x"] = orthogonal(d, cfg.n_kv_heads * hd)
            p["wv_x"] = orthogonal(d, cfg.n_kv_heads * hd)
        return p

    def mamba(spec):
        d_inner = spec.expand * d
        h = d_inner // spec.head_dim
        gn = spec.n_groups * spec.d_state
        return {"in_proj": normal((d, 2 * d_inner + 2 * gn + h), d ** -0.5),
                "conv": {"w": normal((spec.d_conv, d_inner + 2 * gn),
                                     spec.d_conv ** -0.5)},
                "a_log": np.log(np.linspace(1.0, 16.0, h)).astype(
                    np.float32),
                "d_skip": np.ones(h, np.float32),
                "dt_bias": np.zeros(h, np.float32),
                "norm": {"scale": np.ones(d_inner, np.float32)},
                "out_proj": normal((d_inner, d), d_inner ** -0.5)}

    def block(spec):
        if spec.kind == "mamba":
            return {"ln1": {"scale": np.ones(d, np.float32)},
                    "mamba": mamba(spec.ssm)}
        if spec.kind not in ("attn", "moe_attn"):
            raise NotImplementedError(f"block {spec} is not ported yet")
        p = {"ln1": {"scale": np.ones(d, np.float32)},
             "attn": mla(spec.attn) if spec.attn.kind == "mla"
             else gqa(spec.attn)}
        if spec.attn.cross_attn:
            p["ln_x"] = {"scale": np.ones(d, np.float32)}
        p["ln2"] = {"scale": np.ones(d, np.float32)}
        if spec.kind == "moe_attn":
            p["moe"] = moe(spec.moe)
        elif spec.has_mlp and cfg.d_ff > 0:
            p["mlp"] = {"w_gate": normal((d, cfg.d_ff), d ** -0.5),
                        "w_up": normal((d, cfg.d_ff), d ** -0.5),
                        "w_down": normal((cfg.d_ff, d), cfg.d_ff ** -0.5)}
        return p

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    def stage(st):
        cells = [{f"b{i}": block(sp) for i, sp in enumerate(st.blocks)}
                 for _ in range(st.repeat)]
        return cells[0] if st.repeat == 1 else stack(cells)

    lead = (cb,) if cb > 1 else ()
    p = {"embed": normal((*lead, v, d), 0.02)}
    if cfg.frontend is not None:
        e = cfg.frontend.embed_dim
        p["frontend_proj"] = normal((e, d), e ** -0.5)
    p["stages"] = {f"s{i}": stage(st) for i, st in enumerate(cfg.stages)}
    p["final_norm"] = {"scale": np.ones(d, np.float32)}
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((*lead, d, v), d ** -0.5)
    return p


def lm_frontend_from_seed(cfg, n_nodes: int, batch_per_node: int,
                          seed: int) -> np.ndarray:
    """Node-stacked frontend embeddings (N, B, n_tokens, embed_dim) of
    ``cfg.frontend``, 0.1 * N(0, 1), float32, drawn from
    ``numpy.random.default_rng(seed)``: the stub of a vision encoder's
    output that a recorded run and its replay both take."""
    fe = cfg.frontend
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(
        (n_nodes, batch_per_node, fe.n_tokens, fe.embed_dim),
        dtype=np.float32)).astype(np.float32)
