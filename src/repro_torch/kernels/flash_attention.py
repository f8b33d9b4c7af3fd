"""Launcher of the CUDA flash attention (``csrc/flash_attention.cu``).

``ops.flash_attention`` validates the operands and makes the default
positions; this module only allocates the output, launches on the current
stream and counts the launches.
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
    fn = build.library("flash_attention").repro_flash_attention
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i,
                   i, i, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _route_entry():
    fn = build.library("flash_attention").repro_flash_attention_route
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i]
    fn.restype = ctypes.c_int
    return fn


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel's route for these CUDA operands, chosen by shape (and
    16-byte alignment) in the C entry point: ``"tensor_core"`` for head
    dims that are multiples of 16 up to 128, else ``"simt"``."""
    tc = _route_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        q.shape[-1], v.shape[-1])
    return "tensor_core" if tc else "simt"


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
           causal: bool, window: int, scale: float) -> torch.Tensor:
    """Attention of contiguous CUDA q (B, S, H, hd), k (B, T, Hkv, hd), v
    (B, T, Hkv, hdv) of one dtype (fp32 or bf16), int32 positions (B, S) and
    (B, T); ``window`` <= 0 for none.  Returns (B, S, H, hdv) in q's dtype."""
    global launches
    b, s, h, hd = q.shape
    t, hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((b, s, h, hdv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        q_positions.data_ptr(), kv_positions.data_ptr(),
                        out.data_ptr(), b, s, t, h, hkv, hd, hdv, scale,
                        int(causal), window, int(q.dtype == torch.bfloat16),
                        stream)
    build.check("flash_attention", code)
    launches += 1
    return out
