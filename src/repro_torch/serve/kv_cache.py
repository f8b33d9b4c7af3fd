"""Paged KV cache of the port (``src/repro/serve/kv_cache.py``):
block-table-indexed pages from one fixed pool per attention layer.

Every attention layer owns a pool of ``(n_pages, page_size, Hkv, hd)``
pages; a decode slot names its pages in a row of the shared block table
``(n_slots, max_pages_per_slot)`` int32.  Unallocated entries are ``-1``;
page 0 is the dump page, a write and read sink for inactive slots that the
allocator never hands out, so the decode step needs no host-side branch on
slot liveness (the paged kernel reads ``-1`` as page 0 and masks it).

The pools mirror ``models.transformer.init_cache``'s stage/block tree (a
leading ``repeat`` axis for stacked stages) with ``{"k_pages",
"v_pages"}`` leaves.  Where the JAX engine donates the pools to its jitted
step and scatter, the port writes them in place (``index_put_``):
:func:`scatter_prompt` here and the decode step's K/V write in
``models.attention.gqa_decode_paged``.  :class:`PagePool` is the host-side
allocator the scheduler draws from.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PagedKVSpec:
    """Static geometry of the paged cache."""
    page_size: int = 16          # tokens per page
    n_pages: int = 64            # pool size per attention layer (incl. dump)
    max_pages_per_slot: int = 8  # block-table width M

    def __post_init__(self):
        assert self.page_size >= 1 and self.n_pages >= 2, self
        assert self.max_pages_per_slot >= 1, self

    @property
    def max_context(self) -> int:
        """Longest sequence one slot can hold (prompt + generated)."""
        return self.page_size * self.max_pages_per_slot

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)


class PagePool:
    """Host-side page allocator: free list over pages ``1..n_pages-1``.

    Admission reserves a request's worst-case page count up front (so a
    request never waits for pages mid-decode).  Page 0 (the dump page) is
    never allocated."""

    def __init__(self, spec: PagedKVSpec):
        self.spec = spec
        self._free = list(range(spec.n_pages - 1, 0, -1))  # pop() -> low ids

    @property
    def n_free(self) -> int:
        return len(self._free)

    def can_reserve(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` pages; raises if the pool is exhausted (callers gate
        on :meth:`can_reserve` at admission, so this is a logic error)."""
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)}")
        return [self._free.pop() for _ in range(n)]

    def release(self, pages: list[int]) -> None:
        for p in pages:
            assert 0 < p < self.spec.n_pages, p
            self._free.append(p)


# ---------------------------------------------------------------------------
# device-side pools
# ---------------------------------------------------------------------------


def refusal(cfg: ModelConfig) -> str | None:
    """Why the paged path does not serve ``cfg``, or None where it does:
    it covers GQA attention blocks (dense or MoE) of one token stream,
    without sliding windows or cross-attention (the contiguous-cache path,
    ``launch.serve --legacy``, serves the rest)."""
    if cfg.n_codebooks > 1:
        return (f"paged serving takes one token stream, got n_codebooks="
                f"{cfg.n_codebooks}; serve it with the contiguous-cache path "
                f"(--legacy)")
    for st in cfg.stages:
        for sp in st.blocks:
            if sp.kind not in ("attn", "moe_attn") or sp.attn.kind == "mla":
                kind = sp.kind if sp.kind not in ("attn", "moe_attn") \
                    else sp.attn.kind
                return (f"paged serving supports GQA attention blocks only, "
                        f"got kind={kind!r}; serve it with the "
                        f"contiguous-cache path (--legacy)")
            if sp.attn.sliding_window is not None:
                return ("paged serving does not support sliding-window "
                        "layers; serve them with the contiguous-cache path "
                        "(--legacy)")
            if sp.attn.cross_attn:
                return ("paged serving does not support cross-attention "
                        "layers; serve them with the contiguous-cache path "
                        "(--legacy)")
    return None


def validate_config(cfg: ModelConfig) -> None:
    """Raise ValueError for a configuration the paged path does not serve
    (:func:`refusal`), up front."""
    reason = refusal(cfg)
    if reason is not None:
        raise ValueError(reason)


def init_pools(cfg: ModelConfig, spec: PagedKVSpec, dtype=torch.float32,
               device=None) -> dict:
    """Zero-filled per-layer page pools, shaped like ``init_cache``'s tree
    (stacked stages carry the leading ``repeat`` axis)."""
    pools = {}
    for i, st in enumerate(cfg.stages):
        lead = (st.repeat,) if st.repeat > 1 else ()
        shape = (*lead, spec.n_pages, spec.page_size, cfg.n_kv_heads, cfg.hd)
        pools[f"s{i}"] = {
            f"b{j}": {"k_pages": torch.zeros(shape, dtype=dtype,
                                             device=device),
                      "v_pages": torch.zeros(shape, dtype=dtype,
                                             device=device)}
            for j in range(len(st.blocks))}
    return pools


def scatter_prompt(pools: dict, caches: dict, pages: Tensor, *,
                   cfg: ModelConfig, page_size: int) -> dict:
    """Copy one prompt's contiguous prefill caches into its pages, in place.

    ``caches`` is ``forward(mode="prefill")``'s output for a batch-of-one
    prompt with ``cache_len`` >= ``len(pages) * page_size`` (so the ring
    buffer is in position order); ``pages`` holds the slot's page ids,
    (np,) integer.  Returns ``pools``."""
    npg = pages.shape[0]
    span = npg * page_size
    pages = pages.long()
    for i, st in enumerate(cfg.stages):
        for j in range(len(st.blocks)):
            c = caches[f"s{i}"][f"b{j}"]
            p = pools[f"s{i}"][f"b{j}"]
            for src, dst in ((c["k"], p["k_pages"]), (c["v"], p["v_pages"])):
                if st.repeat > 1:    # (R, 1, cl, ...) caches, (R, P, ...) pool
                    rows = src[:, 0, :span]
                    dst[:, pages] = rows.reshape(st.repeat, npg, page_size,
                                                 *rows.shape[2:])
                else:                # (1, cl, ...) caches, (P, ...) pool
                    rows = src[0, :span]
                    dst[pages] = rows.reshape(npg, page_size, *rows.shape[1:])
    return pools
