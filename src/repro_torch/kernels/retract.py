"""Launcher of the CUDA fused polar retraction (``csrc/retract.cu``).

``ops.fused_retract`` validates and shapes the operands; this module only
allocates the outputs, launches on the current stream and counts the
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: launches of this kernel since the last reset (``ops.reset_launch_counts``)
launches = 0

DEFAULT_NS_ITERS = 20

#: the largest r the kernel takes: seven (r/8, r) fp32 panels per CTA of a
#: cluster of 8 must fit 227 KB of shared memory (``kMaxR``)
MAX_R = 256


@functools.cache
def _lib():
    lib = build.library("retract")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_fused_retract.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    lib.repro_fused_retract.restype = ctypes.c_int
    lib.repro_fused_retract_cluster.argtypes = [i]
    lib.repro_fused_retract_cluster.restype = ctypes.c_int
    return lib


def cluster_size(r: int) -> int:
    """CTAs per node of the kernel's (r, r) stage, as the built library
    chooses them (1: one block; 0: r is not taken)."""
    return _lib().repro_fused_retract_cluster(r)


def launch(x: torch.Tensor, g: torch.Tensor, ns_iters: int) -> torch.Tensor:
    """R_x(P_x(g)) for contiguous fp32 CUDA tensors of shape (batch, d, r),
    r <= MAX_R."""
    global launches
    batch, d, r = x.shape

    def empty(*shape):
        return torch.empty(shape, dtype=x.dtype, device=x.device)

    out = empty(batch, d, r)
    # the Grams x^T g and g^T g, then M1 and M2
    pb, pc = empty(batch, r, r), empty(batch, r, r)
    m1, m2 = empty(batch, r, r), empty(batch, r, r)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _lib().repro_fused_retract(
            x.data_ptr(), g.data_ptr(), out.data_ptr(), pb.data_ptr(),
            pc.data_ptr(), m1.data_ptr(), m2.data_ptr(), batch, d, r,
            ns_iters, stream)
    build.check("retract", code)
    launches += 1
    return out
