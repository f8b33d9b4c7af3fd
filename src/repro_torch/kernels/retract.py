"""Launcher of the CUDA fused polar retraction (``csrc/retract.cu``).

``ops.fused_retract`` validates and shapes the operands; this module only
allocates the outputs and scratch, launches on the current stream and counts
the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.stiefel_project import d_chunks

#: launches of this kernel since the last reset (``ops.reset_launch_counts``)
launches = 0

DEFAULT_NS_ITERS = 20

# Shared memory one block may use on sm_90, and the finalize kernel's static
# reduction buffer (256 floats) beside its six dynamic (r, r) matrices; the
# same test decides in retract.cu between shared memory and global scratch.
_MAX_SMEM = 232448
_RED_BYTES = 256 * 4


def needs_scratch(r: int) -> bool:
    """True when the (r, r) stage runs out of global memory (r > 98)."""
    return 6 * r * r * 4 + _RED_BYTES > _MAX_SMEM


@functools.cache
def _entry():
    fn = build.library("retract").repro_fused_retract
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def launch(x: torch.Tensor, g: torch.Tensor, ns_iters: int) -> torch.Tensor:
    """R_x(P_x(g)) for contiguous fp32 CUDA tensors of shape (batch, d, r)."""
    global launches
    batch, d, r = x.shape
    chunk, n_chunks = d_chunks(d)

    def empty(*shape):
        return torch.empty(shape, dtype=x.dtype, device=x.device)

    out = empty(batch, d, r)
    pb, pc = empty(batch, n_chunks, r, r), empty(batch, n_chunks, r, r)
    m1, m2 = empty(batch, r, r), empty(batch, r, r)
    scratch = empty(batch, 6, r, r) if needs_scratch(r) else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _entry()(x.data_ptr(), g.data_ptr(), out.data_ptr(),
                        pb.data_ptr(), pc.data_ptr(), m1.data_ptr(),
                        m2.data_ptr(),
                        None if scratch is None else scratch.data_ptr(),
                        batch, d, r, chunk, n_chunks, ns_iters, stream)
    build.check("retract", code)
    launches += 1
    return out
