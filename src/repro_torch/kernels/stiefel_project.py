"""Launcher of the CUDA Stiefel tangent projection (``csrc/stiefel_project.cu``).

``ops.stiefel_project_leaves`` validates and shapes the operands; this module
only allocates the outputs (one buffer for all the leaves), launches on the
current stream and counts the launches.  A leaf whose rows fit the shared
memory of a cluster (:func:`cluster_size` > 0) takes the on-chip route, ONE
launch for every :data:`~repro_torch.kernels.leaves.MAX_LEAVES` such leaves;
any other leaf streams through the tensor-core Gram and apply, two launches
and a (batch, r, r) tensor for ``sym(x^T g)``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, leaves

#: launches of this kernel since the last reset (``ops.reset_launch_counts``)
launches = 0

_INTS = ctypes.c_int * leaves.MAX_LEAVES


@functools.cache
def _lib():
    lib = build.library("stiefel_project")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_stiefel_project_cluster.argtypes = [i, i]
    lib.repro_stiefel_project_cluster.restype = i
    lib.repro_stiefel_project_leaves.argtypes = [p, p, p, p, p, p, i, p]
    lib.repro_stiefel_project_leaves.restype = i
    lib.repro_stiefel_project_stream.argtypes = [p, p, p, p, i, i, i, p]
    lib.repro_stiefel_project_stream.restype = i
    return lib


@functools.cache
def cluster_size(d: int, r: int) -> int:
    """CTAs per node of the on-chip route for a (d, r) leaf, as the built
    library chooses them; 0 when the leaf streams."""
    return _lib().repro_stiefel_project_cluster(d, r)


def launch(xs: list[torch.Tensor], gs: list[torch.Tensor]
           ) -> list[torch.Tensor]:
    """P_x(g) of each pair of contiguous fp32 CUDA tensors (batch, d, r),
    all on one device."""
    global launches
    lib = _lib()
    outs = leaves.outputs(xs)
    onchip = [j for j, x in enumerate(xs) if cluster_size(*x.shape[1:])]
    with torch.cuda.device(xs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for at in range(0, len(onchip), leaves.MAX_LEAVES):
            part = onchip[at:at + leaves.MAX_LEAVES]
            shapes = [xs[j].shape for j in part]
            build.check("stiefel_project", lib.repro_stiefel_project_leaves(
                leaves.pointers([xs[j] for j in part]),
                leaves.pointers([gs[j] for j in part]),
                leaves.pointers([outs[j] for j in part]),
                _INTS(*(s[0] for s in shapes)), _INTS(*(s[1] for s in shapes)),
                _INTS(*(s[2] for s in shapes)), len(part), stream))
            launches += 1
        for j in sorted(set(range(len(xs))) - set(onchip)):
            batch, d, r = xs[j].shape
            s = torch.empty((batch, r, r), dtype=xs[j].dtype,
                            device=xs[j].device)
            build.check("stiefel_project", lib.repro_stiefel_project_stream(
                xs[j].data_ptr(), gs[j].data_ptr(), outs[j].data_ptr(),
                s.data_ptr(), batch, d, r, stream))
            launches += 2
    return outs
