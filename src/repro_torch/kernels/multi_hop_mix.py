"""Launchers of the CUDA multi-hop ring mixes: fp32 (``csrc/multi_hop_mix.cu``)
and int8 all-hop (``csrc/multi_hop_mix_quant.cu``).

``ops.multi_hop_mix_leaves`` / ``ops.multi_hop_mix_quant_leaves`` validate
and shape the operands; this module picks the block width or the route,
allocates the outputs and scratch, launches on the current stream and
counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, leaves

#: launches of this kernel since the last reset (``ops.reset_launch_counts``)
launches = 0

_MAX_SMEM = 232448     # bytes of shared memory one block may use on sm_90
#: rings up to this many nodes keep a column in registers
#: (``kMaxRegRows`` in ``csrc/multi_hop_mix.cu``); larger ones in shared memory
MAX_REG_ROWS = 32
_REG_THREADS = 64      # block width of the register kernel


def block_width(n: int) -> int:
    """Columns per block: 64 for the register kernel (n <= 32); else 256,
    halved while the block's (n, width) fp32 tile exceeds shared memory.
    Raises when even 32 columns do not fit."""
    if n <= MAX_REG_ROWS:
        return _REG_THREADS
    width = 256
    while n * width * 4 > _MAX_SMEM and width > 32:
        width //= 2
    if n * width * 4 > _MAX_SMEM:
        raise ValueError(f"multi_hop_mix: a ring of {n} nodes does not fit "
                         f"one block's shared memory (at most "
                         f"{_MAX_SMEM // (32 * 4)} nodes)")
    return width


@functools.cache
def _entry():
    fn = build.library("multi_hop_mix").repro_multi_hop_mix
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, ctypes.c_float, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def launch(xs: list[torch.Tensor], hops: int, w_self: float,
           w_side: float) -> list[torch.Tensor]:
    """``hops`` wrapped ring hops of each contiguous fp32 CUDA leaf of
    ``xs`` (all on one device, with the same node count ``n`` on axis 0)."""
    global launches
    outs, made = leaves.run("multi_hop_mix", _entry(), xs, hops, w_self,
                            w_side, block_width(xs[0].shape[0]))
    launches += made
    return outs


def resources(n: int) -> dict:
    """The resources of the kernel an ``n``-node ring takes at its block
    width (``build.resources``: registers, shared memory, resident blocks
    an SM), as the card reports them (``cudaFuncGetAttributes``, the
    occupancy calculator)."""
    return build.resources("multi_hop_mix", "repro_multi_hop_mix_resources",
                           n, block_width(n))


# ---------------------------------------------------------------------------
# int8 all-hop schedule (csrc/multi_hop_mix_quant.cu)
# ---------------------------------------------------------------------------

#: launches of the int8 all-hop kernel since the last reset
quant_launches = 0
#: columns per block of the on-chip route (``kRegThreads``)
QUANT_BLOCK = 512


@functools.cache
def _quant_lib():
    lib = build.library("multi_hop_mix_quant")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_multi_hop_mix_quant.argtypes = [
        p, p, p, p, p, i, p, i, i, ctypes.c_float, ctypes.c_float, i, p]
    lib.repro_multi_hop_mix_quant.restype = ctypes.c_int
    lib.repro_multi_hop_mix_quant_smem.argtypes = [i]
    lib.repro_multi_hop_mix_quant_smem.restype = ctypes.c_longlong
    lib.repro_multi_hop_mix_quant_capacity.argtypes = [i]
    lib.repro_multi_hop_mix_quant_capacity.restype = ctypes.c_longlong
    return lib


@functools.cache
def quant_capacity(device: int, n: int) -> int:
    """Blocks of the on-chip int8 kernel of an ``n``-node ring that card
    ``device`` holds at once (0 for n > MAX_REG_ROWS)."""
    with torch.cuda.device(device):
        return int(_quant_lib().repro_multi_hop_mix_quant_capacity(n))


def quant_onchip(device: int, n: int, fs: list[int]) -> bool:
    """True when a launch of leaves of ``fs`` columns keeps its state on
    chip: n <= MAX_REG_ROWS and one column per thread fits the resident
    grid."""
    blocks = sum(-(-f // QUANT_BLOCK) for f in fs)
    return n <= MAX_REG_ROWS and blocks <= quant_capacity(device, n)


def launch_quant(qs: list[torch.Tensor], scales: list[torch.Tensor],
                 hops: int, w_self: float, w_side: float
                 ) -> list[torch.Tensor]:
    """``hops`` int8-compressed wrapped ring hops of each contiguous int8
    CUDA payload (n, f_j) of ``qs`` with its contiguous fp32 scales (n, 1),
    one launch for every ``leaves.MAX_LEAVES`` leaves (cooperative when it
    spans blocks); returns the fp32 (n, f_j) results, views of one buffer.
    A launch the card refuses raises."""
    global quant_launches
    n = qs[0].shape[0]
    lib = _quant_lib()
    device = qs[0].device
    outs = leaves.outputs(qs, torch.float32)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for at in range(0, len(qs), leaves.MAX_LEAVES):
            part = range(at, min(at + leaves.MAX_LEAVES, len(qs)))
            fs = [qs[j].shape[1] for j in part]
            onchip = quant_onchip(device.index or 0, n, fs)
            if not onchip and lib.repro_multi_hop_mix_quant_smem(n) > _MAX_SMEM:
                raise ValueError(f"multi_hop_mix_quant: a ring of {n} nodes "
                                 f"does not fit one block's shared memory")
            scratch = (leaves.outputs([qs[j] for j in part], torch.float32)
                       if not onchip and hops > 1 else None)
            amax = torch.empty(3 * len(part) * n, dtype=torch.int32,
                               device=device)
            build.check("multi_hop_mix_quant", lib.repro_multi_hop_mix_quant(
                leaves.pointers([qs[j] for j in part]),
                leaves.pointers([scales[j] for j in part]),
                leaves.pointers([outs[j] for j in part]),
                None if scratch is None else leaves.pointers(scratch),
                leaves.columns(fs), len(part), amax.data_ptr(), n, hops,
                w_self, w_side, int(onchip), stream))
            quant_launches += 1
    return outs
