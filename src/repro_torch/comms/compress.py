"""Compression operators for gossip payloads.

Mirrors ``src/repro/comms/compress.py``.  Every compressor maps a
node-stacked leaf ``x`` (axis 0 = node) to the reconstruction its receivers
would decode, plus a static account (pure Python over shapes) of the bits
that crossed the wire.

* ``identity`` -- lossless, 32 bits/entry baseline.
* ``int8``     -- per-node max-abs scale + unbiased stochastic rounding to
  int8 (the payload the ``quant_mix`` kernel consumes).
* ``topk``     -- per-node magnitude top-k sparsification (value + index).
* ``lowrank``  -- randomized rank-p sketch ``Q (Q^T A)`` for matrix leaves
  (the Stiefel parameters); other leaves pass through.

Randomness comes from a **draw source**, not a global generator: an object
with ``uniform(stream, rnd, index, shape, device)`` and
``normal(stream, rnd, index, shape, device)``.  :class:`GeneratorDraws`, the
default, seeds a ``torch.Generator`` from ``(seed, crc32(stream), rnd,
index)`` before each draw, so the draws of one round depend on nothing but
those four values, as the JAX package's ``fold_in`` key derivation does
(``comms/layer.py``).  A :class:`DrawKey` plays the part of a JAX key: the
engine derives one per slot and round, ``fold_in`` picks the leaf (or the
hop), ``sub`` names a further stream (the channel's drop, straggler and
schedule draws).  Tests hand in a source that returns the JAX package's own
draws.
"""
from __future__ import annotations

import dataclasses
import hashlib
import struct
import zlib
from typing import Any

import torch

from repro_torch.comms.spec import CommSpec
from repro_torch.tree import tree_flatten, tree_leaves

Tensor = torch.Tensor

_FLOAT_BITS = 32
_INDEX_BITS = 32
_EPS = 1e-12
# a node-stacked conv kernel (n, O, I, H, W) seen as the JAX package's
# (n, H, W, I, O), and back (see repro_torch.convert)
_TO_REF_VIEW = (0, 3, 4, 2, 1)
_FROM_REF_VIEW = (0, 4, 3, 1, 2)


# ---------------------------------------------------------------------------
# draw sources
# ---------------------------------------------------------------------------


def _salt(stream: str) -> int:
    """The stream's 31-bit salt, the JAX package's ``_salt``."""
    return zlib.crc32(stream.encode()) & 0x7FFFFFFF


class GeneratorDraws:
    """The default draw source: a ``torch.Generator`` seeded from
    ``(seed, crc32(stream), rnd, index)`` before each draw.

    CUDA and CPU generators give different numbers from one seed.  With
    ``on_cpu=True`` every draw is made on the CPU and then moved to the
    requested device, so a run on the card and a run on the CPU see the
    same draws.
    """

    def __init__(self, seed: int = 0, on_cpu: bool = False):
        self.seed = seed
        self.on_cpu = on_cpu

    def _generator(self, stream: str, rnd: int, index: int, device
                   ) -> tuple[torch.Generator, torch.device]:
        dev = torch.device("cpu") if self.on_cpu else torch.device(device)
        digest = hashlib.blake2b(struct.pack(
            "<qqqq", self.seed, _salt(stream), int(rnd), int(index)),
            digest_size=8).digest()
        gen = torch.Generator(device=dev)
        gen.manual_seed(int.from_bytes(digest, "little") & (2 ** 63 - 1))
        return gen, dev

    def uniform(self, stream: str, rnd: int, index: int, shape, device
                ) -> Tensor:
        """U[0, 1) float32 of ``shape`` on ``device``."""
        gen, dev = self._generator(stream, rnd, index, device)
        return torch.rand(shape, generator=gen, device=dev).to(device)

    def normal(self, stream: str, rnd: int, index: int, shape, device
               ) -> Tensor:
        """N(0, 1) float32 of ``shape`` on ``device``."""
        gen, dev = self._generator(stream, rnd, index, device)
        return torch.randn(shape, generator=gen, device=dev).to(device)

    def __repr__(self):
        return f"GeneratorDraws(seed={self.seed}, on_cpu={self.on_cpu})"


@dataclasses.dataclass(frozen=True)
class DrawKey:
    """A position in a draw source: stream name, round and index."""
    source: Any
    stream: str
    rnd: int
    index: int = 0

    def fold_in(self, index: int) -> "DrawKey":
        return dataclasses.replace(self, index=index)

    def sub(self, name: str) -> "DrawKey":
        return dataclasses.replace(self, stream=f"{self.stream}/{name}")

    def uniform(self, shape, device) -> Tensor:
        return self.source.uniform(self.stream, self.rnd, self.index,
                                   tuple(shape), device)

    def normal(self, shape, device) -> Tensor:
        return self.source.normal(self.stream, self.rnd, self.index,
                                  tuple(shape), device)


# ---------------------------------------------------------------------------
# compressors
# ---------------------------------------------------------------------------


def _size(shape) -> int:
    size = 1
    for s in shape:
        size *= s
    return size


class Compressor:
    """Base: lossless pass-through (the full-precision wire)."""

    name = "identity"

    def __call__(self, key: DrawKey, x: Tensor) -> Tensor:
        return x

    def bits(self, shape: tuple[int, ...]) -> float:
        return float(_size(shape) * _FLOAT_BITS)


IdentityCompressor = Compressor


def _per_node_scale(x: Tensor) -> Tensor:
    """max-abs over everything but the node axis / 127, floored at 1e-12,
    shaped to broadcast.  The divisor is a tensor: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal, which is not the IEEE
    quotient the JAX package and the kernels compute."""
    dims = tuple(range(1, x.ndim))
    amax = x.abs().amax(dim=dims, keepdim=True) if dims else x.abs()
    return torch.clamp_min(amax / amax.new_full((), 127.0), _EPS).float()


def quantize_det(x: Tensor) -> tuple[Tensor, Tensor]:
    """Deterministic int8: round-to-nearest (half to even) with the same
    per-node max-abs scale as :class:`Int8Stochastic`.  The all-hop
    compressed ``W^k`` schedule requantizes with THIS formula at every hop
    (``multi_hop_mix_quant``)."""
    scale = _per_node_scale(x)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


@dataclasses.dataclass(frozen=True)
class Int8Stochastic(Compressor):
    """Unbiased stochastic int8: q = floor(x/scale + U[0,1)), per-node scale."""

    name = "int8"

    def quantize(self, key: DrawKey, x: Tensor) -> tuple[Tensor, Tensor]:
        scale = _per_node_scale(x)
        u = key.uniform(x.shape, x.device)
        q = torch.floor(x.float() / scale + u)
        return torch.clamp(q, -127, 127).to(torch.int8), scale

    def dequantize(self, q: Tensor, scale: Tensor, dtype) -> Tensor:
        return (q.float() * scale).to(dtype)

    def __call__(self, key: DrawKey, x: Tensor) -> Tensor:
        q, scale = self.quantize(key, x)
        return self.dequantize(q, scale, x.dtype)

    def bits(self, shape: tuple[int, ...]) -> float:
        return float(_size(shape) * 8 + shape[0] * _FLOAT_BITS)


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Keep the largest-magnitude ``frac`` of entries per node, zero the rest."""

    frac: float = 0.05
    name = "topk"

    def _k(self, shape: tuple[int, ...]) -> int:
        return max(1, int(round(self.frac * _size(shape[1:]))))

    def __call__(self, key: DrawKey, x: Tensor) -> Tensor:
        flat = x.reshape(x.shape[0], -1)
        idx = torch.topk(flat.abs(), self._k(x.shape), dim=1).indices
        out = torch.zeros_like(flat).scatter(1, idx, flat.gather(1, idx))
        return out.reshape(x.shape)

    def bits(self, shape: tuple[int, ...]) -> float:
        return float(shape[0] * self._k(shape) * (_FLOAT_BITS + _INDEX_BITS))


@dataclasses.dataclass(frozen=True)
class LowRank(Compressor):
    """Randomized rank-p sketch per node for matrix leaves (ndim >= 3):
    Y = A Omega, Q = qr(Y), reconstruction Q (Q^T A).  Transmits Q and
    Q^T A, i.e. p(d + r) floats instead of d*r.

    The sketch runs on the JAX package's matrices: a node-stacked conv
    kernel, the port's only 5-D leaf, is kept OIHW here and HWIO there, so
    it is sketched in the HWIO view, as (I, O) matrices, and turned back.
    """

    rank: int = 4
    name = "lowrank"

    def _eligible(self, shape: tuple[int, ...]) -> bool:
        return len(shape) >= 3 and min(shape[-2], shape[-1]) > self.rank

    @staticmethod
    def _ref_shape(shape: tuple[int, ...]) -> tuple[int, ...]:
        if len(shape) == 5:
            return tuple(shape[i] for i in _TO_REF_VIEW)
        return tuple(shape)

    def __call__(self, key: DrawKey, x: Tensor) -> Tensor:
        conv = x.ndim == 5
        a = x.permute(_TO_REF_VIEW) if conv else x
        if not self._eligible(tuple(a.shape)):
            return x
        n, d, r = a.shape[0], a.shape[-2], a.shape[-1]
        omega = key.normal((r, self.rank), x.device)
        af = a.reshape(n, -1, d, r).float()
        y = torch.einsum("nbdr,rp->nbdp", af, omega)
        q = torch.linalg.qr(y).Q
        rec = torch.einsum("nbdp,nbpr->nbdr", q,
                           torch.einsum("nbdp,nbdr->nbpr", q, af))
        rec = rec.reshape(a.shape).to(x.dtype)
        return rec.permute(_FROM_REF_VIEW).contiguous() if conv else rec

    def bits(self, shape: tuple[int, ...]) -> float:
        ref = self._ref_shape(shape)
        if not self._eligible(ref):
            return Compressor.bits(self, shape)
        return float(_size(ref[:-2]) * self.rank * (ref[-2] + ref[-1])
                     * _FLOAT_BITS)


def make_compressor(comm: CommSpec) -> Compressor:
    if comm.compressor == "none":
        return IdentityCompressor()
    if comm.compressor == "int8":
        return Int8Stochastic()
    if comm.compressor == "topk":
        return TopK(frac=comm.topk_frac)
    if comm.compressor == "lowrank":
        return LowRank(rank=comm.rank)
    raise ValueError(f"unknown compressor {comm.compressor!r}")


# ---------------------------------------------------------------------------
# tree helpers
# ---------------------------------------------------------------------------


def compress_tree(comp: Compressor, key: DrawKey, tree):
    """Apply ``comp`` leaf-wise, leaf ``i`` (flatten order) drawing at
    ``key.fold_in(i)``."""
    leaves, unflatten = tree_flatten(tree)
    return unflatten([comp(key.fold_in(i), leaf)
                      for i, leaf in enumerate(leaves)])


def tree_bits(comp: Compressor, tree) -> float:
    """Total bits one gossip transmission of ``tree`` puts on the wire."""
    return sum(comp.bits(tuple(leaf.shape)) for leaf in tree_leaves(tree))


def tree_param_count(tree) -> int:
    return sum(int(leaf.numel()) for leaf in tree_leaves(tree))
