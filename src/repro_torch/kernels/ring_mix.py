"""Launcher of the CUDA ring hop (``csrc/ring_mix.cu``).

``ops.ring_mix_leaves`` validates and shapes the operands; this module only
allocates the outputs, launches on the current stream (one launch per
:data:`~repro_torch.kernels.leaves.MAX_LEAVES` leaves) and counts the
launches.
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
    fn = build.library("ring_mix").repro_ring_mix
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, ctypes.c_float, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def launch(xs: list[torch.Tensor], w_self: float,
           w_side: float) -> list[torch.Tensor]:
    """One wrapped ring hop of each contiguous fp32 CUDA leaf of ``xs``
    (all on one device, with the same node count ``n`` on axis 0)."""
    global launches
    outs, made = leaves.run("ring_mix", _entry(), xs, w_self, w_side)
    launches += made
    return outs
