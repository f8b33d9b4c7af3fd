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

#: launches of this kernel since the last reset (``ops.reset_launch_counts``),
#: and of those, the launches that took the global route (r > MAX_R)
launches = 0
global_launches = 0

DEFAULT_NS_ITERS = 20

#: the largest r of the cluster routes, whose (r, r) stage keeps seven
#: (r/8, r) fp32 panels per CTA of a cluster of 8 in 227 KB of shared memory
#: (``kMaxR``); a larger r takes the global route (the (r, r) stage as
#: tensor-core GEMMs over global memory, ``2 ns_iters + 8`` launches)
MAX_R = 256


def configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the C entry points' signatures of a loaded ``retract.cu``
    library (this module's, or a variant's in ``launch/kernel_variants``)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_fused_retract.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                        p]
    lib.repro_fused_retract.restype = ctypes.c_int
    lib.repro_fused_retract_cluster.argtypes = [i]
    lib.repro_fused_retract_cluster.restype = ctypes.c_int
    lib.repro_fused_retract_workspace.argtypes = [i, i]
    lib.repro_fused_retract_workspace.restype = ctypes.c_longlong
    return lib


@functools.cache
def _lib():
    return configure(build.library("retract"))


@functools.cache
def cluster_size(r: int) -> int:
    """CTAs per node of the kernel's (r, r) stage, as the built library
    chooses them: 1 (one block, r <= 32), 4 or 8 (a cluster, r <= MAX_R),
    0 (the global route, r > MAX_R)."""
    return _lib().repro_fused_retract_cluster(r)


def launch(x: torch.Tensor, g: torch.Tensor, ns_iters: int) -> torch.Tensor:
    """R_x(P_x(g)) for contiguous fp32 CUDA tensors of shape (batch, d, r),
    any r >= 1."""
    global launches, global_launches
    batch, d, r = x.shape

    def empty(*shape):
        return torch.empty(shape, dtype=x.dtype, device=x.device)

    out = empty(batch, d, r)
    # the Grams x^T g and g^T g, then M1 and M2
    pb, pc = empty(batch, r, r), empty(batch, r, r)
    m1, m2 = empty(batch, r, r), empty(batch, r, r)
    # the global route's (r, r) matrices, row sums and scales (none below)
    ws = empty(_lib().repro_fused_retract_workspace(batch, r))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _lib().repro_fused_retract(
            x.data_ptr(), g.data_ptr(), out.data_ptr(), pb.data_ptr(),
            pc.data_ptr(), m1.data_ptr(), m2.data_ptr(),
            ws.data_ptr() if ws.numel() else None, batch, d, r, ns_iters,
            stream)
    build.check("retract", code)
    launches += 1
    global_launches += cluster_size(r) == 0
    return out
