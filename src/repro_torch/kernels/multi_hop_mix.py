"""Launchers of the CUDA multi-hop ring mixes: fp32 (``csrc/multi_hop_mix.cu``)
and int8 all-hop (``csrc/multi_hop_mix_quant.cu``).

``ops.multi_hop_mix_leaves`` / ``ops.multi_hop_mix_quant`` validate and
shape the operands; this module picks the block width, allocates the
outputs and scratch, launches on the current stream and counts the
launches.
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


def resources(n: int) -> tuple[int, int]:
    """(registers per thread, resident blocks per SM) of the register
    kernel of an ``n``-node ring at its block width, as the card reports
    them (``cudaFuncGetAttributes``, the occupancy calculator)."""
    lib = build.library("multi_hop_mix")
    fn = lib.repro_multi_hop_mix_resources
    fn.restype = ctypes.c_int
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    build.check("multi_hop_mix", fn(n, block_width(n), ctypes.byref(regs),
                                    ctypes.byref(blocks)))
    return regs.value, blocks.value


# ---------------------------------------------------------------------------
# int8 all-hop schedule (csrc/multi_hop_mix_quant.cu)
# ---------------------------------------------------------------------------

#: launches of the int8 all-hop kernel since the last reset
quant_launches = 0


@functools.cache
def _quant_lib():
    lib = build.library("multi_hop_mix_quant")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_multi_hop_mix_quant.argtypes = [
        p, p, p, p, p, i, ctypes.c_longlong, i, ctypes.c_float,
        ctypes.c_float, p]
    lib.repro_multi_hop_mix_quant.restype = ctypes.c_int
    lib.repro_multi_hop_mix_quant_smem.argtypes = [i]
    lib.repro_multi_hop_mix_quant_smem.restype = ctypes.c_longlong
    return lib


def launch_quant(q: torch.Tensor, scale: torch.Tensor, hops: int,
                 w_self: float, w_side: float) -> torch.Tensor:
    """``hops`` int8-compressed wrapped ring hops of a contiguous int8 CUDA
    payload (n, f) with contiguous fp32 scales (n, 1), in one cooperative
    launch; returns fp32 (n, f).  A launch the card refuses raises."""
    global quant_launches
    n, f = q.shape
    lib = _quant_lib()
    if lib.repro_multi_hop_mix_quant_smem(n) > _MAX_SMEM:
        raise ValueError(f"multi_hop_mix_quant: a ring of {n} nodes does not "
                         f"fit one block's shared memory")
    out = torch.empty((n, f), dtype=torch.float32, device=q.device)
    scratch = torch.empty_like(out) if hops > 1 else out
    amax = torch.empty(3 * n, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.repro_multi_hop_mix_quant(
            q.data_ptr(), scale.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            amax.data_ptr(), n, f, hops, w_self, w_side, stream)
    build.check("multi_hop_mix_quant", code)
    quant_launches += 1
    return out
