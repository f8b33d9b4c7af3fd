"""Model assembly of the port (``src/repro/models/transformer.py``): the
dense ``"attn"`` block (GQA + SwiGLU) in stages of stacked repeats.

Entry points, plain functions over dicts of tensors:

  * ``forward``      - logits over a full sequence (``mode="prefill"`` also
                       returns contiguous KV caches);
  * ``decode_step``  - one new token against per-layer caches: contiguous
                       ``{"k", "v", "pos"}`` caches, or the paged serving
                       path's ``{"k_pages", "v_pages"}`` pools, with
                       ``position`` then ``(position, block_table)``;
  * ``init_params`` / ``init_cache`` - constructors;
                       ``abstract_params`` - the parameter tree's shapes.

A :class:`Stage` repeats a supercell ``repeat`` times; its parameters and
caches carry a leading ``repeat`` axis, as the JAX tree does, so that
``repro_torch.convert`` is a plain copy.  The repeats run as a Python loop
over that axis (``lax.scan`` in the JAX package); decode caches are views of
the stacked tensors and are written in place.  The block kinds
``moe_attn``, ``mamba``, ``mlstm`` and ``slstm`` are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import BlockSpec, ModelConfig, Stage
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (dense_init, draw_device, embed_init,
                                       rmsnorm, rmsnorm_init, swiglu,
                                       swiglu_init)
from repro_torch.tree import tree_map

Tensor = torch.Tensor


def _check_block(spec: BlockSpec) -> None:
    """Refuse what the port does not run yet: other block kinds, MLA and
    cross-attention."""
    if spec.kind != "attn":
        raise NotImplementedError(f"block kind {spec.kind!r} is not ported "
                                  f"yet")
    if spec.attn.kind != "gqa":
        raise NotImplementedError(f"attention kind {spec.attn.kind!r} is not "
                                  f"ported yet")
    if spec.attn.cross_attn:
        raise NotImplementedError("cross-attention is not ported yet")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_block(generator: torch.Generator, cfg: ModelConfig, spec: BlockSpec,
               dtype=torch.float32) -> dict:
    _check_block(spec)
    dev = draw_device(generator)
    p = {"ln1": rmsnorm_init(cfg.d_model, dtype, dev),
         "attn": attn_mod.init_gqa(generator, cfg, spec.attn, dtype),
         "ln2": rmsnorm_init(cfg.d_model, dtype, dev)}
    if spec.has_mlp and cfg.d_ff > 0:
        p["mlp"] = swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype)
    return p


def init_stage(generator: torch.Generator, cfg: ModelConfig, stage: Stage,
               dtype=torch.float32) -> dict:
    def one():
        return {f"b{i}": init_block(generator, cfg, sp, dtype)
                for i, sp in enumerate(stage.blocks)}
    if stage.repeat == 1:
        return one()
    per = [one() for _ in range(stage.repeat)]
    return tree_map(lambda *xs: torch.stack(xs), *per)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                dtype=torch.float32, device=None) -> dict:
    """Parameters drawn with ``generator`` (on its device), then moved to
    ``device`` (default: the generator's); ``meta`` tensors without a
    generator."""
    p = {"embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, dtype),
         "stages": {f"s{i}": init_stage(generator, cfg, st, dtype)
                    for i, st in enumerate(cfg.stages)},
         "final_norm": rmsnorm_init(cfg.d_model, dtype,
                                    draw_device(generator))}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, cfg.d_model, cfg.padded_vocab,
                                  dtype=dtype)
    if device is not None:
        p = tree_map(lambda t: t.to(device), p)
    return p


def abstract_params(cfg: ModelConfig, dtype=torch.float32) -> dict:
    """The tree of :func:`init_params` as ``meta`` tensors (shapes and
    dtypes, no storage and no draws): the template the LM objective reads
    its manifold map from, the counterpart of the JAX package's
    ``jax.eval_shape(init_params)``."""
    return init_params(None, cfg, dtype)


# ---------------------------------------------------------------------------
# contiguous caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, bsz: int, cache_seq_len: int,
               dtype=torch.float32, device=None) -> dict:
    """Empty contiguous caches (positions -1), stacked per stage."""
    caches = {}
    for i, st in enumerate(cfg.stages):
        cell = {}
        for j, sp in enumerate(st.blocks):
            _check_block(sp)
            cl = attn_mod.attn_cache_len(sp.attn, cache_seq_len)
            lead = (st.repeat,) if st.repeat > 1 else ()
            shape = (*lead, bsz, cl, cfg.n_kv_heads, cfg.hd)
            cell[f"b{j}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "pos": torch.full((*lead, bsz, cl), -1, dtype=torch.int32,
                                  device=device)}
        caches[f"s{i}"] = cell
    return caches


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def apply_block(params: dict, cfg: ModelConfig, spec: BlockSpec, x: Tensor,
                positions, mode: str, cache: dict | None,
                cache_len: int | None = None):
    """Returns (x, new_cache)."""
    _check_block(spec)
    a = spec.attn
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        fn = attn_mod.gqa_decode_paged if "k_pages" in cache \
            else attn_mod.gqa_decode
        y, cache = fn(params["attn"], h, cfg, a, positions, cache)
    else:
        cl = attn_mod.attn_cache_len(a, cache_len or x.shape[1])
        y, cache = attn_mod.gqa_prefill(params["attn"], h, cfg, a, positions,
                                        make_cache=(mode == "prefill"),
                                        cache_len=cl)
    x = x + y
    if "mlp" in params:
        x = x + swiglu(params["mlp"], rmsnorm(params["ln2"], x, cfg.norm_eps))
    return x, cache


def _apply_supercell(cell_params: dict, cfg: ModelConfig, stage: Stage,
                     x: Tensor, positions, mode: str,
                     cell_cache: dict | None, cache_len: int | None):
    new_caches = {}
    for j, sp in enumerate(stage.blocks):
        bc = None if cell_cache is None else cell_cache[f"b{j}"]
        x, new_caches[f"b{j}"] = apply_block(
            cell_params[f"b{j}"], cfg, sp, x, positions, mode, bc, cache_len)
    return x, new_caches


def apply_stage(stage_params: dict, cfg: ModelConfig, stage: Stage,
                x: Tensor, positions, mode: str, stage_cache: dict | None,
                cache_len: int | None = None):
    """Returns (x, caches | None): prefill stacks the repeats' new caches
    on the leading axis; decode writes ``stage_cache`` in place."""
    want_cache = mode in ("prefill", "decode")
    if stage.repeat == 1:
        x, nc = _apply_supercell(stage_params, cfg, stage, x, positions,
                                 mode, stage_cache, cache_len)
        return x, (nc if want_cache else None)
    new_caches = []
    for i in range(stage.repeat):
        p_i = tree_map(lambda t: t[i], stage_params)
        c_i = None if stage_cache is None else \
            tree_map(lambda t: t[i], stage_cache)
        x, nc = _apply_supercell(p_i, cfg, stage, x, positions, mode, c_i,
                                 cache_len)
        new_caches.append(nc)
    if mode == "decode":
        return x, stage_cache
    if want_cache:
        return x, tree_map(lambda *ts: torch.stack(ts), *new_caches)
    return x, None


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def embed_tokens(params: dict, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    return params["embed"][tokens]


def unembed(params: dict, cfg: ModelConfig, h: Tensor) -> Tensor:
    if cfg.tie_embeddings:
        return h @ params["embed"].T
    return h @ params["lm_head"]


def forward(params: dict, cfg: ModelConfig, tokens: Tensor, *,
            mode: str = "train", cache_len: int | None = None,
            last_logits_only: bool = False):
    """tokens: (B, S) integer.  Returns (logits, aux, caches | None); aux is
    the MoE router loss, 0 for the dense blocks ported so far."""
    b, s = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    caches = {}
    for i, st in enumerate(cfg.stages):
        x, nc = apply_stage(params["stages"][f"s{i}"], cfg, st, x, positions,
                            mode, None, cache_len)
        if nc is not None:
            caches[f"s{i}"] = nc
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if last_logits_only:
        x = x[:, -1:]
    logits = unembed(params, cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, (caches if mode == "prefill" else None)


def decode_step(params: dict, cfg: ModelConfig, token: Tensor, position,
                caches: dict):
    """token: (B,) integer; position: (B,) int32, or ``(position,
    block_table)`` for paged pools.  One decode step; the caches are
    written in place.  Returns (logits (B, V), caches)."""
    x = embed_tokens(params, cfg, token[:, None])
    for i, st in enumerate(cfg.stages):
        x, _ = apply_stage(params["stages"][f"s{i}"], cfg, st, x, position,
                           "decode", caches[f"s{i}"])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, cfg, x)[:, 0], caches
