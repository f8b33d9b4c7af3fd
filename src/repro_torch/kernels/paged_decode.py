"""Launcher of the CUDA paged decode attention (``csrc/paged_decode.cu``).

``ops.paged_decode_attention`` validates the operands; this module only
allocates the output, launches on the current stream and counts the
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: launches of this kernel since the last reset (``ops.reset_launch_counts``)
launches = 0


@functools.cache
def _entry():
    fn = build.library("paged_decode").repro_paged_decode
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i,
                   i, p]
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
    out = torch.empty((s, h, hdv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _entry()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                        block_table.data_ptr(), seq_lens.data_ptr(),
                        out.data_ptr(), s, block_table.shape[1], ps, hkv,
                        h // hkv, hd, hdv, scale, window,
                        int(q.dtype == torch.bfloat16), stream)
    build.check("paged_decode", code)
    launches += 1
    return out
