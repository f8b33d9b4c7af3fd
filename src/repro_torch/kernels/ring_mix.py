"""Launcher of the CUDA ring hop (``csrc/ring_mix.cu``).

``ops.ring_mix`` validates and shapes the operand; this module only
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
    fn = build.library("ring_mix").repro_ring_mix
    p = ctypes.c_void_p
    fn.argtypes = [p, p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def launch(x: torch.Tensor, w_self: float, w_side: float) -> torch.Tensor:
    """One wrapped ring hop of a contiguous fp32 CUDA tensor (n, f)."""
    global launches
    n, f = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _entry()(x.data_ptr(), out.data_ptr(), n, f, w_self, w_side,
                        stream)
    build.check("ring_mix", code)
    launches += 1
    return out
