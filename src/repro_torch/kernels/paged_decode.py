"""Launcher of the CUDA paged decode attention (``csrc/paged_decode.cu``).

``ops.paged_decode_attention`` validates the operands; this module plans
the split over each slot's keys (:func:`split_plan`), allocates the output
and the partials' scratch, keeps the combine's tickets, launches on the
current stream and counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: launches of this kernel since the last reset (``ops.reset_launch_counts``)
launches = 0

#: the most keys of one block of the kernel (``kChunk`` in the source)
CHUNK_KEYS = 64
#: partials (m, l, acc) a chunk publishes: one per warp of 32 keys
PARTIALS_PER_CHUNK = 2

# (device index, stream) -> int32 tickets, zero between calls: the kernel's
# last block of each (slot, kv head) resets its own
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def split_plan(m_pages: int, page_size: int) -> tuple[int, int]:
    """(chunk, n_chunks): each (slot, kv head)'s ``m_pages * page_size``
    key positions are cut into ``n_chunks`` chunks of ``chunk`` tokens,
    chunk c holding positions [c * chunk, (c + 1) * chunk).  A chunk is
    whole pages, as many as fit in CHUNK_KEYS tokens; a page larger than
    that is cut into CHUNK_KEYS-token chunks.  Sized from the table's
    width alone: seq_lens live on the card."""
    if m_pages < 1 or page_size < 1:
        raise ValueError(f"paged_decode: m_pages={m_pages}, "
                         f"page_size={page_size}")
    chunk = (CHUNK_KEYS // page_size) * page_size or CHUNK_KEYS
    return chunk, -(-m_pages * page_size // chunk)


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """The zeroed ticket buffer of (device, stream), at least ``n`` long:
    made (one fill) the first time and when it must grow, then kept."""
    key = (device.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


@functools.cache
def _entry():
    fn = build.library("paged_decode").repro_paged_decode
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                   ctypes.c_float, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def launch(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
           block_table: torch.Tensor, seq_lens: torch.Tensor, *, window: int,
           scale: float) -> torch.Tensor:
    """One decode token per slot: contiguous CUDA q (S, H, hd) and pools
    (P, ps, Hkv, hd/hdv) of one dtype (fp32 or bf16), int32 block table
    (S, M) and seq_lens (S,); ``window`` <= 0 for none.  Returns
    (S, H, hdv) in q's dtype."""
    global launches
    s, h, hd = q.shape
    ps, hkv = k_pages.shape[1], k_pages.shape[2]
    hdv = v_pages.shape[-1]
    m = block_table.shape[1]
    chunk, n_chunks = split_plan(m, ps)
    out = torch.empty((s, h, hdv), dtype=q.dtype, device=q.device)
    part = torch.empty(s * hkv * n_chunks * PARTIALS_PER_CHUNK
                       * (h // hkv) * (hdv + 2),
                       dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        tickets = _tickets(q.device, stream, s * hkv)
        code = _entry()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                        block_table.data_ptr(), seq_lens.data_ptr(),
                        out.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                        s, m, ps, hkv, h // hkv, hd, hdv, scale, window,
                        chunk, n_chunks, int(q.dtype == torch.bfloat16),
                        stream)
    build.check("paged_decode", code)
    launches += 1
    return out
