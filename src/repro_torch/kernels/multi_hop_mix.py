"""Launchers of the CUDA multi-hop ring mixes: fp32 (``csrc/multi_hop_mix.cu``)
and int8 all-hop (``csrc/multi_hop_mix_quant.cu``).

``ops.multi_hop_mix`` / ``ops.multi_hop_mix_quant`` validate and shape the
operands; this module picks the block width, allocates the output and
scratch, launches on the current stream and counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: launches of this kernel since the last reset (``ops.reset_launch_counts``)
launches = 0

_MAX_SMEM = 232448     # bytes of shared memory one block may use on sm_90


def block_width(n: int) -> int:
    """Columns per block: 256, halved while the block's (n, width) fp32
    tile exceeds shared memory; raises when even 32 columns do not fit."""
    width = 256
    while n * width * 4 > _MAX_SMEM and width > 32:
        width //= 2
    if n * width * 4 > _MAX_SMEM:
        raise ValueError(f"multi_hop_mix: a ring of {n} nodes does not fit "
                         f"one block's shared memory (at most "
                         f"{_MAX_SMEM // (32 * 4)} nodes)")
    return width


@functools.cache
def _entry():
    fn = build.library("multi_hop_mix").repro_multi_hop_mix
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, ctypes.c_longlong, i, ctypes.c_float,
                   ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def launch(x: torch.Tensor, hops: int, w_self: float,
           w_side: float) -> torch.Tensor:
    """``hops`` wrapped ring hops of a contiguous fp32 CUDA tensor (n, f)."""
    global launches
    n, f = x.shape
    width = block_width(n)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _entry()(x.data_ptr(), out.data_ptr(), n, f, hops, w_self,
                        w_side, width, stream)
    build.check("multi_hop_mix", code)
    launches += 1
    return out


# ---------------------------------------------------------------------------
# int8 all-hop schedule (csrc/multi_hop_mix_quant.cu)
# ---------------------------------------------------------------------------

#: launches of the int8 all-hop kernel since the last reset
quant_launches = 0


@functools.cache
def _quant_lib():
    lib = build.library("multi_hop_mix_quant")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_multi_hop_mix_quant.argtypes = [
        p, p, p, p, p, i, ctypes.c_longlong, i, ctypes.c_float,
        ctypes.c_float, p]
    lib.repro_multi_hop_mix_quant.restype = ctypes.c_int
    lib.repro_multi_hop_mix_quant_smem.argtypes = [i]
    lib.repro_multi_hop_mix_quant_smem.restype = ctypes.c_longlong
    return lib


def launch_quant(q: torch.Tensor, scale: torch.Tensor, hops: int,
                 w_self: float, w_side: float) -> torch.Tensor:
    """``hops`` int8-compressed wrapped ring hops of a contiguous int8 CUDA
    payload (n, f) with contiguous fp32 scales (n, 1), in one cooperative
    launch; returns fp32 (n, f).  A launch the card refuses raises."""
    global quant_launches
    n, f = q.shape
    lib = _quant_lib()
    if lib.repro_multi_hop_mix_quant_smem(n) > _MAX_SMEM:
        raise ValueError(f"multi_hop_mix_quant: a ring of {n} nodes does not "
                         f"fit one block's shared memory")
    out = torch.empty((n, f), dtype=torch.float32, device=q.device)
    scratch = torch.empty_like(out) if hops > 1 else out
    amax = torch.empty(3 * n, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_multi_hop_mix_quant(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            amax.data_ptr(), n, f, hops, w_self, w_side, stream)
    build.check("multi_hop_mix_quant", code)
    quant_launches += 1
    return out
