"""GQA attention sublayer of the port (``src/repro/models/attention.py``).

Plain functions over dicts of tensors.  The score / softmax / PV core goes
through ``repro_torch.kernels.ops``: ``flash_attention`` for prefill and
the contiguous-cache decode, ``paged_decode_attention`` for the paged
serving path.  MLA and cross-attention are not ported yet
(``models.transformer`` refuses them).

Contiguous KV caches are ring buffers, slot = position % cache_len, with an
explicit ``pos`` array (-1 = empty) for masking, as in the JAX package.
Where JAX returns updated copies, the port writes caches and page pools in
place (``index_put_``) and returns the same tensors: a decode step never
copies a cache.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import AttnSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, orthogonal_init

Tensor = torch.Tensor


def init_gqa(generator: torch.Generator, cfg: ModelConfig, spec: AttnSpec,
             dtype=torch.float32) -> dict:
    hd, h, hkv, d = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    return {"wq": orthogonal_init(generator, d, h * hd, dtype),
            "wk": orthogonal_init(generator, d, hkv * hd, dtype),
            "wv": orthogonal_init(generator, d, hkv * hd, dtype),
            "wo": orthogonal_init(generator, h * hd, d, dtype)}


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
        _cache_write_many(cache, k, v, positions)
    return out, cache


def gqa_decode(params: dict, x: Tensor, cfg: ModelConfig, spec: AttnSpec,
               position: Tensor, cache: dict):
    """One-token decode against a contiguous cache, written in place.
    x: (B, 1, d); position: (B,) int32."""
    b = x.shape[0]
    pos2 = position[:, None]
    q, k, v = _qkv(params, x, cfg, pos2)
    _cache_write_one(cache, k[:, 0], v[:, 0], position)
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


def _cache_write_many(cache: dict, k: Tensor, v: Tensor,
                      positions: Tensor) -> dict:
    """Write (B, S, ...) rows at slots ``positions % cache_len``, in place.
    Positions increase along S (as prefill gives them), so when S exceeds
    the cache only the last ``cache_len`` rows are kept."""
    cl = cache["k"].shape[1]
    k, v, positions = k[:, -cl:], v[:, -cl:], positions[:, -cl:]
    rows = torch.arange(k.shape[0], device=k.device)[:, None]
    slots = (positions % cl).long()
    cache["k"][rows, slots] = k
    cache["v"][rows, slots] = v
    cache["pos"][rows, slots] = positions.to(torch.int32)
    return cache


def _cache_write_one(cache: dict, k1: Tensor, v1: Tensor,
                     position: Tensor) -> dict:
    """Write one (B, ...) row per batch row at ``position % cache_len``."""
    cl = cache["k"].shape[1]
    rows = torch.arange(k1.shape[0], device=k1.device)
    slot = (position % cl).long()
    cache["k"][rows, slot] = k1
    cache["v"][rows, slot] = v1
    cache["pos"][rows, slot] = position.to(torch.int32)
    return cache


def attn_cache_len(spec: AttnSpec, seq_len: int) -> int:
    if spec.sliding_window is not None:
        return min(seq_len, spec.sliding_window)
    return seq_len
