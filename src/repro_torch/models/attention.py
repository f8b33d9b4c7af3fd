"""Attention sublayers of the port (``src/repro/models/attention.py``):
GQA (with sliding windows), MLA (DeepSeek-V2's multi-head latent
attention) and cross-attention onto a frontend's embeddings.

Plain functions over dicts of tensors.  The score / softmax / PV core goes
through ``repro_torch.kernels.ops``: ``flash_attention`` for prefill, the
contiguous-cache decode, MLA and cross-attention, and
``paged_decode_attention`` for the paged serving path (GQA only).

Contiguous KV caches are ring buffers, slot = position % cache_len, with an
explicit ``pos`` array (-1 = empty) for masking, as in the JAX package.
MLA caches the compressed ``{c_kv, k_rope, pos}`` and expands K and V over
the whole cache at every decode step, as the JAX package does.  Where JAX
returns updated copies, the port writes caches and page pools in place
(``index_put_``) and returns the same tensors: a decode step never copies
a cache.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import AttnSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, orthogonal_init

Tensor = torch.Tensor


def init_gqa(generator: torch.Generator, cfg: ModelConfig, spec: AttnSpec,
             dtype=torch.float32) -> dict:
    """wq, wk, wv, wo orthonormal; a cross-attention block also projects
    the frontend's keys and values (``wk_x``, ``wv_x``) and reuses wq and
    wo for its queries and output, as the JAX package does."""
    hd, h, hkv, d = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    p = {"wq": orthogonal_init(generator, d, h * hd, dtype),
         "wk": orthogonal_init(generator, d, hkv * hd, dtype),
         "wv": orthogonal_init(generator, d, hkv * hd, dtype),
         "wo": orthogonal_init(generator, h * hd, d, dtype)}
    if spec.cross_attn:
        p["wk_x"] = orthogonal_init(generator, d, hkv * hd, dtype)
        p["wv_x"] = orthogonal_init(generator, d, hkv * hd, dtype)
    return p


def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   spec: AttnSpec, dtype=torch.float32) -> dict:
    if spec.kind == "mla":
        return init_mla(generator, cfg, spec, dtype)
    return init_gqa(generator, cfg, spec, dtype)


def _qkv(params: dict, x: Tensor, cfg: ModelConfig, positions: Tensor):
    """Projected, rotated q (B, S, H, hd) and k, and v (B, S, Hkv, hd)."""
    b, s, _ = x.shape
    hd, h, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (x @ params["wk"]).reshape(b, s, hkv, hd)
    v = (x @ params["wv"]).reshape(b, s, hkv, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def gqa_prefill(params: dict, x: Tensor, cfg: ModelConfig, spec: AttnSpec,
                positions: Tensor, *, make_cache: bool = False,
                cache_len: int = 0):
    """x: (B, S, d); positions (B, S) int32.  Returns (y, cache | None)."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions)
    y = ops.flash_attention(q, k, v, causal=True, window=spec.sliding_window,
                            q_positions=positions, kv_positions=positions)
    out = y.reshape(b, s, -1) @ params["wo"]
    cache = None
    if make_cache:
        cache = _new_kv_cache(b, cache_len or s, cfg.n_kv_heads, cfg.hd,
                              k.dtype, x.device)
        _write_many(cache, {"k": k, "v": v}, positions)
    return out, cache


def gqa_decode(params: dict, x: Tensor, cfg: ModelConfig, spec: AttnSpec,
               position: Tensor, cache: dict):
    """One-token decode against a contiguous cache, written in place.
    x: (B, 1, d); position: (B,) int32."""
    b = x.shape[0]
    pos2 = position[:, None]
    q, k, v = _qkv(params, x, cfg, pos2)
    _write_one(cache, {"k": k[:, 0], "v": v[:, 0]}, position)
    y = ops.flash_attention(q, cache["k"], cache["v"], causal=True,
                            window=spec.sliding_window, q_positions=pos2,
                            kv_positions=cache["pos"])
    return y.reshape(b, 1, -1) @ params["wo"], cache


def gqa_decode_paged(params: dict, x: Tensor, cfg: ModelConfig,
                     spec: AttnSpec, pos_bt, cache: dict):
    """One-token decode against a paged KV pool (``repro_torch.serve``).

    ``pos_bt`` is ``(position, block_table)``: per-slot positions (S,) int32
    of the incoming token and the shared block table (S, M) int32.
    ``cache`` holds this layer's ``{"k_pages", "v_pages"}`` pools.  The new
    token's K/V are written in place into the slot's current page (inactive
    slots, whose table row is -1, write to the dump page 0: no host-side
    branch on liveness), then attention runs through the block-table
    kernel with ``seq_lens = position + 1``."""
    position, block_table = pos_bt
    s = x.shape[0]
    pos2 = position[:, None]
    q, k, v = _qkv(params, x, cfg, pos2)
    ps = cache["k_pages"].shape[1]
    slots = torch.arange(s, device=x.device)
    page = block_table[slots, (position // ps).long()].long().clamp(min=0)
    off = (position % ps).long()
    cache["k_pages"].index_put_((page, off), k[:, 0])
    cache["v_pages"].index_put_((page, off), v[:, 0])
    y = ops.paged_decode_attention(q[:, 0], cache["k_pages"],
                                   cache["v_pages"], block_table,
                                   position + 1, window=spec.sliding_window)
    return y.reshape(s, 1, -1) @ params["wo"], cache


def cross_attend(params: dict, x: Tensor, cfg: ModelConfig,
                 frontend_kv: dict) -> Tensor:
    """Cross-attention of x (B, S, d) onto precomputed frontend K/V (not
    causal, no rotary embedding, default positions)."""
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
    y = ops.flash_attention(q, frontend_kv["k"], frontend_kv["v"],
                            causal=False)
    return y.reshape(b, s, -1) @ params["wo"]


def make_frontend_kv(params: dict, embeds: Tensor, cfg: ModelConfig) -> dict:
    """Frontend embeddings (B, N, d_model) projected into K/V (B, N, Hkv,
    hd)."""
    b, n, _ = embeds.shape
    hd, hkv = cfg.hd, cfg.n_kv_heads
    return {"k": (embeds @ params["wk_x"]).reshape(b, n, hkv, hd),
            "v": (embeds @ params["wv_x"]).reshape(b, n, hkv, hd)}


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(generator: torch.Generator, cfg: ModelConfig, spec: AttnSpec,
             dtype=torch.float32) -> dict:
    """The down projections (``w_dq`` when ``q_lora_rank`` > 0, ``w_dkv``
    to the latent c_kv and the shared rotary key) N(0, 1/d_in); the up
    projections and ``wo`` orthonormal, as the JAX initializers scale
    them."""
    d, h = cfg.d_model, cfg.n_heads
    dq, dkv = spec.q_lora_rank, spec.kv_lora_rank
    dn, dr, dv = spec.qk_nope_head_dim, spec.qk_rope_head_dim, spec.v_head_dim
    p = {}
    if dq:
        p["w_dq"] = dense_init(generator, d, dq, dtype=dtype)
    p["w_dkv"] = dense_init(generator, d, dkv + dr, dtype=dtype)
    p["w_uk"] = orthogonal_init(generator, dkv, h * dn, dtype)
    p["w_uv"] = orthogonal_init(generator, dkv, h * dv, dtype)
    p["wo"] = orthogonal_init(generator, h * dv, d, dtype)
    p["w_uq"] = orthogonal_init(generator, dq or d, h * (dn + dr), dtype)
    return p


def _mla_scale(spec: AttnSpec) -> float:
    return (spec.qk_nope_head_dim + spec.qk_rope_head_dim) ** -0.5


def _mla_qkv(params: dict, x: Tensor, cfg: ModelConfig, spec: AttnSpec,
             positions: Tensor):
    """q (B, S, H, dn + dr) with its rotary part rotated, the latent c_kv
    (B, S, kv_lora_rank) and the rotated shared key k_rope (B, S, dr)."""
    b, s, _ = x.shape
    dn, dr = spec.qk_nope_head_dim, spec.qk_rope_head_dim
    cq = x @ params["w_dq"] if "w_dq" in params else x
    q = (cq @ params["w_uq"]).reshape(b, s, cfg.n_heads, dn + dr)
    q = torch.cat([q[..., :dn],
                   apply_rope(q[..., dn:], positions, cfg.rope_theta)], dim=-1)
    ckv = x @ params["w_dkv"]
    c_kv, k_rope = ckv[..., :spec.kv_lora_rank], ckv[..., spec.kv_lora_rank:]
    k_rope = apply_rope(k_rope[..., None, :], positions,
                        cfg.rope_theta)[..., 0, :]
    return q, c_kv, k_rope


def _mla_expand_kv(params: dict, c_kv: Tensor, k_rope: Tensor,
                   spec: AttnSpec, h: int):
    """K (B, T, H, dn + dr), the rotary key shared by every head, and V
    (B, T, H, dv) from the latent."""
    b, t, _ = c_kv.shape
    dn, dr, dv = spec.qk_nope_head_dim, spec.qk_rope_head_dim, spec.v_head_dim
    k_nope = (c_kv @ params["w_uk"]).reshape(b, t, h, dn)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, t, h, dr)], dim=-1)
    v = (c_kv @ params["w_uv"]).reshape(b, t, h, dv)
    return k, v


def mla_prefill(params: dict, x: Tensor, cfg: ModelConfig, spec: AttnSpec,
                positions: Tensor, *, make_cache: bool = False,
                cache_len: int = 0):
    """x: (B, S, d); positions (B, S) int32.  Returns (y, the compressed
    cache | None)."""
    b, s, _ = x.shape
    q, c_kv, k_rope = _mla_qkv(params, x, cfg, spec, positions)
    k, v = _mla_expand_kv(params, c_kv, k_rope, spec, cfg.n_heads)
    y = ops.flash_attention(q, k, v, causal=True, window=spec.sliding_window,
                            q_positions=positions, kv_positions=positions,
                            softmax_scale=_mla_scale(spec))
    out = y.reshape(b, s, -1) @ params["wo"]
    cache = None
    if make_cache:
        cl = cache_len or s
        cache = {"c_kv": x.new_zeros((b, cl, spec.kv_lora_rank)),
                 "k_rope": x.new_zeros((b, cl, spec.qk_rope_head_dim)),
                 "pos": torch.full((b, cl), -1, dtype=torch.int32,
                                   device=x.device)}
        _write_many(cache, {"c_kv": c_kv, "k_rope": k_rope}, positions)
    return out, cache


def mla_decode(params: dict, x: Tensor, cfg: ModelConfig, spec: AttnSpec,
               position: Tensor, cache: dict):
    """One-token decode against the compressed cache, written in place;
    K and V are expanded over the whole cache for the attention.
    x: (B, 1, d); position: (B,) int32."""
    b = x.shape[0]
    pos2 = position[:, None]
    q, c_kv, k_rope = _mla_qkv(params, x, cfg, spec, pos2)
    _write_one(cache, {"c_kv": c_kv[:, 0], "k_rope": k_rope[:, 0]}, position)
    k, v = _mla_expand_kv(params, cache["c_kv"], cache["k_rope"], spec,
                          cfg.n_heads)
    y = ops.flash_attention(q, k, v, causal=True, window=spec.sliding_window,
                            q_positions=pos2, kv_positions=cache["pos"],
                            softmax_scale=_mla_scale(spec))
    return y.reshape(b, 1, -1) @ params["wo"], cache


# ---------------------------------------------------------------------------
# contiguous KV caches (ring buffers with explicit positions)
# ---------------------------------------------------------------------------


def _new_kv_cache(b: int, cache_len: int, hkv: int, hd: int, dtype,
                  device=None) -> dict:
    return {"k": torch.zeros((b, cache_len, hkv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((b, cache_len, hkv, hd), dtype=dtype,
                             device=device),
            "pos": torch.full((b, cache_len), -1, dtype=torch.int32,
                              device=device)}


def _write_many(cache: dict, values: dict, positions: Tensor) -> dict:
    """Write each of ``values``' (B, S, ...) rows into the cache entry of
    its name at slots ``positions % cache_len``, and the positions into
    ``pos``, in place.  Positions increase along S (as prefill gives
    them), so when S exceeds the cache only the last ``cache_len`` rows
    are kept."""
    cl = cache["pos"].shape[1]
    positions = positions[:, -cl:]
    rows = torch.arange(positions.shape[0], device=positions.device)[:, None]
    slots = (positions % cl).long()
    for name, val in values.items():
        cache[name][rows, slots] = val[:, -cl:]
    cache["pos"][rows, slots] = positions.to(torch.int32)
    return cache


def _write_one(cache: dict, values: dict, position: Tensor) -> dict:
    """Write one (B, ...) row per batch row of each of ``values`` at
    ``position % cache_len``, and the position into ``pos``, in place."""
    cl = cache["pos"].shape[1]
    rows = torch.arange(position.shape[0], device=position.device)
    slot = (position % cl).long()
    for name, val in values.items():
        cache[name][rows, slot] = val
    cache["pos"][rows, slot] = position.to(torch.int32)
    return cache


def attn_cache_len(spec: AttnSpec, seq_len: int) -> int:
    if spec.sliding_window is not None:
        return min(seq_len, spec.sliding_window)
    return seq_len
