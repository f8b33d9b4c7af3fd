"""Launcher of the CUDA compressed ring hop (``csrc/quant_mix.cu``).

``ops.quant_mix`` validates and shapes the operands; this module only
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
    fn = build.library("quant_mix").repro_quant_mix
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                   ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def launch(q: torch.Tensor, scale: torch.Tensor, w_self: float,
           w_side: float) -> torch.Tensor:
    """One wrapped compressed ring hop of a contiguous int8 CUDA payload
    (n, f) with contiguous fp32 scales (n, 1); returns fp32 (n, f)."""
    global launches
    n, f = q.shape
    out = torch.empty((n, f), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _entry()(q.data_ptr(), scale.data_ptr(), out.data_ptr(), n, f,
                        w_self, w_side, stream)
    build.check("quant_mix", code)
    launches += 1
    return out
