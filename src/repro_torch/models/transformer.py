"""Model assembly of the port (``src/repro/models/transformer.py``): the
dense ``"attn"`` block (attention + SwiGLU), the ``"moe_attn"`` block
(attention + the routed experts of ``models/moe.py``) and the ``"mamba"``
block (the Mamba2 mixer of ``models/ssm.py``, no MLP) in stages of stacked
repeats, with GQA or MLA attention (``models/attention.py``), an optional
cross-attention sublayer onto a stubbed modality frontend (Llama-3.2
Vision: precomputed embeddings, projected by ``frontend_proj``), and one
token stream or ``n_codebooks`` parallel ones (MusicGen: the codebooks'
embeddings summed, one output head each).

Entry points, plain functions over dicts of tensors:

  * ``forward``      - logits over a full sequence (``mode="prefill"`` also
                       returns contiguous caches);
  * ``decode_step``  - one new token against per-layer caches: contiguous
                       ``{"k", "v", "pos"}`` caches (MLA: the compressed
                       ``{"c_kv", "k_rope", "pos"}``; Mamba2: the
                       ``{"ssm", "conv"}`` state), or the paged serving
                       path's ``{"k_pages", "v_pages"}`` pools, with
                       ``position`` then ``(position, block_table)``;
  * ``init_params`` / ``init_cache`` - constructors;
                       ``abstract_params`` - the parameter tree's shapes.

Both take ``frontend_embeds`` (B, n_tokens, embed_dim); without them a
cross-attention sublayer is skipped, as in the JAX package, and with them
every cross layer projects the frontend's K/V anew at every call (decode
steps included).  A :class:`Stage` repeats a supercell ``repeat`` times;
its parameters and caches carry a leading ``repeat`` axis, as the JAX tree
does, so that ``repro_torch.convert`` is a plain copy.  The repeats run as
a Python loop over that axis (``lax.scan`` in the JAX package); decode
caches are views of the stacked tensors and are written in place.  The MoE
router's auxiliary loss is summed over blocks and stages, as in the JAX
package.  The xLSTM block kinds ``mlstm`` and ``slstm`` are not ported
yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import BlockSpec, ModelConfig, Stage
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (dense_init, draw_device, embed_init,
                                       rmsnorm, rmsnorm_init, swiglu,
                                       swiglu_init)
from repro_torch.tree import tree_map

Tensor = torch.Tensor


def _check_block(spec: BlockSpec) -> None:
    """Refuse what the port does not run yet: the xLSTM block kinds."""
    if spec.kind not in ("attn", "moe_attn", "mamba"):
        raise NotImplementedError(f"block kind {spec.kind!r} is not ported "
                                  f"yet")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_block(generator: torch.Generator, cfg: ModelConfig, spec: BlockSpec,
               dtype=torch.float32) -> dict:
    _check_block(spec)
    dev = draw_device(generator)
    if spec.kind == "mamba":
        return {"ln1": rmsnorm_init(cfg.d_model, dtype, dev),
                "mamba": ssm_mod.init_mamba(generator, cfg, spec.ssm, dtype)}
    p = {"ln1": rmsnorm_init(cfg.d_model, dtype, dev),
         "attn": attn_mod.init_attention(generator, cfg, spec.attn, dtype)}
    if spec.attn.cross_attn:
        p["ln_x"] = rmsnorm_init(cfg.d_model, dtype, dev)
    p["ln2"] = rmsnorm_init(cfg.d_model, dtype, dev)
    if spec.kind == "moe_attn":
        p["moe"] = moe_mod.init_moe(generator, cfg, spec.moe, dtype)
    elif spec.has_mlp and cfg.d_ff > 0:
        p["mlp"] = swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype)
    return p


def init_stage(generator: torch.Generator, cfg: ModelConfig, stage: Stage,
               dtype=torch.float32) -> dict:
    """The supercell's parameters, with a leading ``repeat`` axis when it
    repeats: each stacked leaf is allocated once and every repeat is drawn
    in turn into its slice, so that init holds one repeat above the
    weights (the draws and their order are those of stacking the repeats'
    trees)."""
    def one():
        return {f"b{i}": init_block(generator, cfg, sp, dtype)
                for i, sp in enumerate(stage.blocks)}
    first = one()
    if stage.repeat == 1:
        return first
    stacked = tree_map(lambda t: t.new_empty((stage.repeat, *t.shape)),
                       first)
    tree_map(lambda dst, src: dst[0].copy_(src), stacked, first)
    del first
    for i in range(1, stage.repeat):
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, one())
    return stacked


def init_params(generator: torch.Generator, cfg: ModelConfig,
                dtype=torch.float32, device=None) -> dict:
    """Parameters drawn with ``generator`` (on its device), then moved to
    ``device`` (default: the generator's); ``meta`` tensors without a
    generator.  With codebooks, ``embed`` is a (CB, V, d) stack and
    ``lm_head`` a (CB, d, V) stack; with a frontend, ``frontend_proj``
    (embed_dim, d) N(0, 1/embed_dim)."""
    v, d, cb = cfg.padded_vocab, cfg.d_model, cfg.n_codebooks

    def per_codebook(make):
        return make() if cb == 1 else torch.stack([make() for _ in range(cb)])

    p = {"embed": per_codebook(lambda: embed_init(generator, v, d, dtype))}
    if cfg.frontend is not None:
        p["frontend_proj"] = dense_init(generator, cfg.frontend.embed_dim, d,
                                        dtype=dtype)
    p["stages"] = {f"s{i}": init_stage(generator, cfg, st, dtype)
                   for i, st in enumerate(cfg.stages)}
    p["final_norm"] = rmsnorm_init(d, dtype, draw_device(generator))
    if not cfg.tie_embeddings:
        p["lm_head"] = per_codebook(lambda: dense_init(generator, d, v,
                                                       dtype=dtype))
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
    """Empty contiguous caches (positions -1), stacked per stage: GQA
    ``{k, v, pos}``, MLA the compressed ``{c_kv, k_rope, pos}``, Mamba2
    the zero state ``{ssm, conv}``."""
    caches = {}
    for i, st in enumerate(cfg.stages):
        lead = (st.repeat,) if st.repeat > 1 else ()
        cell = {}
        for j, sp in enumerate(st.blocks):
            _check_block(sp)
            if sp.kind == "mamba":
                cell[f"b{j}"] = ssm_mod.init_mamba_cache(
                    cfg, sp.ssm, bsz, dtype, device, lead)
                continue
            a = sp.attn
            cl = attn_mod.attn_cache_len(a, cache_seq_len)
            if a.kind == "mla":
                rows = {"c_kv": (a.kv_lora_rank,),
                        "k_rope": (a.qk_rope_head_dim,)}
            else:
                rows = {"k": (cfg.n_kv_heads, cfg.hd),
                        "v": (cfg.n_kv_heads, cfg.hd)}
            cell[f"b{j}"] = {
                **{name: torch.zeros((*lead, bsz, cl, *shape), dtype=dtype,
                                     device=device)
                   for name, shape in rows.items()},
                "pos": torch.full((*lead, bsz, cl), -1, dtype=torch.int32,
                                  device=device)}
        caches[f"s{i}"] = cell
    return caches


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------


def apply_block(params: dict, cfg: ModelConfig, spec: BlockSpec, x: Tensor,
                positions, mode: str, cache: dict | None,
                frontend_embeds: Tensor | None = None,
                cache_len: int | None = None):
    """Returns (x, aux, new_cache); aux is the MoE router loss, the Python
    number 0.0 for a dense block (no device work on the dense path).
    ``frontend_embeds`` (B, N, d_model), already projected, feed a
    cross-attention sublayer; without them it is skipped."""
    _check_block(spec)
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if spec.kind == "mamba":
        if mode == "decode":
            y, cache = ssm_mod.mamba_decode(params["mamba"], h, cfg,
                                            spec.ssm, cache)
        else:
            y, cache = ssm_mod.mamba_prefill(params["mamba"], h, cfg,
                                             spec.ssm,
                                             make_cache=(mode == "prefill"))
        return x + y, 0.0, cache
    a = spec.attn
    if mode == "decode":
        if a.kind == "mla":
            fn = attn_mod.mla_decode
        elif "k_pages" in cache:
            fn = attn_mod.gqa_decode_paged
        else:
            fn = attn_mod.gqa_decode
        y, cache = fn(params["attn"], h, cfg, a, positions, cache)
    else:
        fn = attn_mod.mla_prefill if a.kind == "mla" else attn_mod.gqa_prefill
        cl = attn_mod.attn_cache_len(a, cache_len or x.shape[1])
        y, cache = fn(params["attn"], h, cfg, a, positions,
                      make_cache=(mode == "prefill"), cache_len=cl)
    x = x + y
    if a.cross_attn and frontend_embeds is not None:
        fkv = attn_mod.make_frontend_kv(params["attn"], frontend_embeds, cfg)
        x = x + attn_mod.cross_attend(
            params["attn"], rmsnorm(params["ln_x"], x, cfg.norm_eps), cfg,
            fkv)
    aux = 0.0
    if spec.kind == "moe_attn":
        y2, aux = moe_mod.apply_moe(
            params["moe"], rmsnorm(params["ln2"], x, cfg.norm_eps), spec.moe)
        x = x + y2
    elif "mlp" in params:
        x = x + swiglu(params["mlp"], rmsnorm(params["ln2"], x, cfg.norm_eps))
    return x, aux, cache


def _apply_supercell(cell_params: dict, cfg: ModelConfig, stage: Stage,
                     x: Tensor, positions, mode: str,
                     cell_cache: dict | None, frontend_embeds: Tensor | None,
                     cache_len: int | None):
    aux_total = 0.0
    new_caches = {}
    for j, sp in enumerate(stage.blocks):
        bc = None if cell_cache is None else cell_cache[f"b{j}"]
        x, aux, new_caches[f"b{j}"] = apply_block(
            cell_params[f"b{j}"], cfg, sp, x, positions, mode, bc,
            frontend_embeds, cache_len)
        aux_total = aux_total + aux
    return x, aux_total, new_caches


def apply_stage(stage_params: dict, cfg: ModelConfig, stage: Stage,
                x: Tensor, positions, mode: str, stage_cache: dict | None,
                frontend_embeds: Tensor | None = None,
                cache_len: int | None = None):
    """Returns (x, aux, caches | None): prefill stacks the repeats' new
    caches on the leading axis; decode writes ``stage_cache`` in place."""
    want_cache = mode in ("prefill", "decode")
    if stage.repeat == 1:
        x, aux, nc = _apply_supercell(stage_params, cfg, stage, x, positions,
                                      mode, stage_cache, frontend_embeds,
                                      cache_len)
        return x, aux, (nc if want_cache else None)
    aux_total = 0.0
    new_caches = []
    for i in range(stage.repeat):
        p_i = tree_map(lambda t: t[i], stage_params)
        c_i = None if stage_cache is None else \
            tree_map(lambda t: t[i], stage_cache)
        x, aux, nc = _apply_supercell(p_i, cfg, stage, x, positions, mode,
                                      c_i, frontend_embeds, cache_len)
        aux_total = aux_total + aux
        new_caches.append(nc)
    if mode == "decode":
        return x, aux_total, stage_cache
    if want_cache:
        return x, aux_total, tree_map(lambda *ts: torch.stack(ts),
                                      *new_caches)
    return x, aux_total, None


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def embed_tokens(params: dict, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    """tokens (B, S), or (B, S, CB): the sum of the codebooks'
    embeddings, in codebook order (MusicGen)."""
    if cfg.n_codebooks > 1:
        return sum(params["embed"][c][tokens[..., c]]
                   for c in range(cfg.n_codebooks))
    return params["embed"][tokens]


def unembed(params: dict, cfg: ModelConfig, h: Tensor) -> Tensor:
    """(B, S, d) -> logits (B, S, V), or (B, S, CB, V) with codebooks."""
    if cfg.tie_embeddings:
        if cfg.n_codebooks > 1:
            return torch.einsum("bsd,cvd->bscv", h, params["embed"])
        return h @ params["embed"].T
    if cfg.n_codebooks > 1:
        return torch.einsum("bsd,cdv->bscv", h, params["lm_head"])
    return h @ params["lm_head"]


def project_frontend(params: dict, cfg: ModelConfig,
                     frontend_embeds: Tensor | None) -> Tensor | None:
    """Frontend embeddings (B, N, embed_dim) projected to d_model, or None
    without them or without a frontend."""
    if frontend_embeds is None or cfg.frontend is None:
        return None
    return frontend_embeds @ params["frontend_proj"]


def forward(params: dict, cfg: ModelConfig, tokens: Tensor, *,
            frontend_embeds: Tensor | None = None, mode: str = "train",
            cache_len: int | None = None, last_logits_only: bool = False):
    """tokens: (B, S) integer, or (B, S, CB) with codebooks;
    ``frontend_embeds`` (B, N, embed_dim) for a model with a frontend.
    Returns (logits, aux, caches | None); aux is the MoE router loss summed
    over blocks and stages (0 without MoE blocks)."""
    b, s = tokens.shape[:2]
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    fe = project_frontend(params, cfg, frontend_embeds)
    aux_total = 0.0
    caches = {}
    for i, st in enumerate(cfg.stages):
        x, aux, nc = apply_stage(params["stages"][f"s{i}"], cfg, st, x,
                                 positions, mode, None, fe, cache_len)
        aux_total = aux_total + aux
        if nc is not None:
            caches[f"s{i}"] = nc
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if last_logits_only:
        x = x[:, -1:]
    logits = unembed(params, cfg, x)
    if not torch.is_tensor(aux_total):
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux_total, (caches if mode == "prefill" else None)


def decode_step(params: dict, cfg: ModelConfig, token: Tensor, position,
                caches: dict, *, frontend_embeds: Tensor | None = None):
    """token: (B,) integer, or (B, CB) with codebooks; position: (B,)
    int32, or ``(position, block_table)`` for paged pools;
    ``frontend_embeds`` as for :func:`forward`.  One decode step; the
    caches are written in place.  Returns (logits (B, V) or (B, CB, V),
    caches)."""
    x = embed_tokens(params, cfg, token[:, None])
    fe = project_frontend(params, cfg, frontend_embeds)
    for i, st in enumerate(cfg.stages):
        x, _, _ = apply_stage(params["stages"][f"s{i}"], cfg, st, x,
                              position, "decode", caches[f"s{i}"], fe)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params, cfg, x)[:, 0], caches
