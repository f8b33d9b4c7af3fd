"""Host side of a grouped launch over node-stacked leaves
(``csrc/leaves.cuh``): one output buffer for all the leaves, and one launch
for every :data:`MAX_LEAVES` of them (the int8 kernels and the Stiefel
projection build their own launches from :func:`outputs`, :func:`pointers`
and :func:`columns`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: leaves per launch (``kMaxLeaves`` in ``csrc/leaves.cuh``)
MAX_LEAVES = 16

_PTRS = ctypes.c_void_p * MAX_LEAVES
_COLS = ctypes.c_longlong * MAX_LEAVES


def outputs(xs: list[torch.Tensor],
            dtype: torch.dtype | None = None) -> list[torch.Tensor]:
    """Outputs of the leaves' shapes (in ``dtype``, by default the
    leaves'), all in ONE ``torch.empty``: each is a contiguous view at its
    own offset, rounded up to 16 bytes (for 4-byte elements) so that the
    kernels' float4 paths stay open."""
    sizes = [(x.numel() + 3) & ~3 for x in xs]
    buf = torch.empty(sum(sizes), dtype=dtype or xs[0].dtype,
                      device=xs[0].device)
    outs, at = [], 0
    for x, size in zip(xs, sizes):
        outs.append(buf.as_strided(x.shape, x.stride(), at))
        at += size
    return outs


def pointers(ts: list[torch.Tensor | None]):
    """The tensors' data pointers as a C array of ``MAX_LEAVES`` (null for
    None)."""
    return _PTRS(*[None if t is None else t.data_ptr() for t in ts])


def columns(fs: list[int]):
    """Column counts as a C array of ``MAX_LEAVES``."""
    return _COLS(*fs)


def run(name: str, entry, xs: list[torch.Tensor], *args
        ) -> tuple[list[torch.Tensor], int]:
    """Mix the contiguous CUDA leaves ``xs`` (one device, one node count
    ``n`` on axis 0) with the C entry ``entry(x pointers, out pointers,
    columns, count, n, *args, stream)`` of kernel library ``name``, on the
    current stream, once for every :data:`MAX_LEAVES` leaves.  Returns the
    outputs and the launches made; a launch the card refuses raises."""
    n = xs[0].shape[0]
    outs = outputs(xs)
    made = 0
    with torch.cuda.device(xs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        for at in range(0, len(xs), MAX_LEAVES):
            part = range(at, min(at + MAX_LEAVES, len(xs)))
            build.check(name, entry(
                pointers([xs[j] for j in part]),
                pointers([outs[j] for j in part]),
                columns([xs[j].numel() // n for j in part]), len(part), n,
                *args, stream))
            made += 1
    return outs, made
