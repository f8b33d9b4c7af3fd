"""Launcher of the CUDA Stiefel tangent projection (``csrc/stiefel_project.cu``).

``ops.stiefel_project`` validates and shapes the operands; this module only
allocates the outputs and scratch, launches on the current stream and counts
the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: launches of this kernel since the last reset (``ops.reset_launch_counts``)
launches = 0

# The Gram over d is split into at most this many chunks of partial sums.
MAX_CHUNKS = 16


def d_chunks(d: int) -> tuple[int, int]:
    """(chunk rows, number of chunks) splitting ``d`` for the partial Grams:
    chunks of 64 rows or more, a multiple of 16, at most ``MAX_CHUNKS``."""
    n = min(MAX_CHUNKS, -(-d // 64))
    per = -(-d // n)
    chunk = -(-per // 16) * 16
    return chunk, -(-d // chunk)


@functools.cache
def _entry():
    fn = build.library("stiefel_project").repro_stiefel_project
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def launch(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """P_x(g) for contiguous fp32 CUDA tensors of shape (batch, d, r)."""
    global launches
    batch, d, r = x.shape
    chunk, n_chunks = d_chunks(d)
    out = torch.empty_like(x)
    partial = torch.empty((batch, n_chunks, r, r), dtype=x.dtype,
                          device=x.device)
    sym = torch.empty((batch, r, r), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _entry()(x.data_ptr(), g.data_ptr(), out.data_ptr(),
                        partial.data_ptr(), sym.data_ptr(), batch, d, r,
                        chunk, n_chunks, stream)
    build.check("stiefel_project", code)
    launches += 1
    return out
