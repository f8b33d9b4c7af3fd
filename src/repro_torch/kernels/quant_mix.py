"""Launcher of the CUDA compressed ring hop (``csrc/quant_mix.cu``).

``ops.quant_mix_leaves`` validates and shapes the operands; this module only
allocates the outputs (one buffer for all the leaves), launches on the
current stream (one launch per :data:`~repro_torch.kernels.leaves.MAX_LEAVES`
leaves) and counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, leaves

#: launches of this kernel since the last reset (``ops.reset_launch_counts``)
launches = 0


@functools.cache
def _entry():
    fn = build.library("quant_mix").repro_quant_mix
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, ctypes.c_float, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def launch(qs: list[torch.Tensor], scales: list[torch.Tensor],
           bases: list[torch.Tensor] | None, w_self: float,
           w_side: float) -> list[torch.Tensor]:
    """One wrapped compressed ring hop of each contiguous int8 CUDA payload
    (n, f) of ``qs`` with its contiguous fp32 scales (n, 1), plus, with
    ``bases``, the exact ring hop of each contiguous fp32 base (n, f); all
    on one device with one n.  Returns fp32 (n, f) per leaf."""
    global launches
    n = qs[0].shape[0]
    outs = leaves.outputs(qs, torch.float32)
    with torch.cuda.device(qs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for at in range(0, len(qs), leaves.MAX_LEAVES):
            part = range(at, min(at + leaves.MAX_LEAVES, len(qs)))
            build.check("quant_mix", _entry()(
                leaves.pointers([qs[j] for j in part]),
                leaves.pointers([scales[j] for j in part]),
                leaves.pointers([None if bases is None else bases[j]
                                 for j in part]),
                leaves.pointers([outs[j] for j in part]),
                leaves.columns([qs[j].shape[1] for j in part]), len(part), n,
                w_self, w_side, stream))
            launches += 1
    return outs
