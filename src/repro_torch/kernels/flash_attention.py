"""Launchers of the CUDA flash attention (``csrc/flash_attention.cu``) and
of its backward (``csrc/flash_attention_bwd.cu``).

``ops.flash_attention`` validates the operands, makes the default
positions and carries the gradient (``torch.autograd.Function``s with a
``vmap`` rule); this module only allocates the outputs, launches on the
current stream and counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: launches of this kernel since the last reset (``ops.reset_launch_counts``)
launches = 0
#: launches of the backward kernels (two a call: dq, then dk/dv)
bwd_launches = 0


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


@functools.cache
def _bwd_entry():
    fn = build.library("flash_attention_bwd").repro_flash_attention_bwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 12 + [i] * 7 + [ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def launch_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, d_out: torch.Tensor,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor, *,
                    causal: bool, window: int, scale: float
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of the attention of contiguous fp32 CUDA q (B, S, H, hd),
    k (B, T, Hkv, hd), v (B, T, Hkv, hdv), its output ``out`` and the
    cotangent ``d_out`` (B, S, H, hdv), int32 positions (B, S) and (B, T);
    ``window`` <= 0 for none.  Two kernel launches, counted."""
    global bwd_launches
    b, s, h, hd = q.shape
    t, hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # per query row and head: the log-sum-exp and rowsum(d_out * out)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    drows = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _bwd_entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            d_out.data_ptr(), q_positions.data_ptr(), kv_positions.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
            drows.data_ptr(), b, s, t, h, hkv, hd, hdv, scale, int(causal),
            window, stream)
    build.check("flash_attention_bwd", code)
    bwd_launches += 2
    return dq, dk, dv
