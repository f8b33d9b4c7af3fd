"""The stacked mix backend: node axis = axis 0 of every leaf, one card.

Mirrors ``StackedBackend`` of ``src/repro/comms/backend.py``.  Ring hops go
through the port's kernels (``ops`` picks the CUDA kernel for a tensor on
the card, the plain version on the CPU):

  * ``mix`` with ``steps == 1``       -> one ``ring_mix`` launch per tree;
  * ``mix`` with ``steps > 1``        -> one ``multi_hop_mix`` launch per
    tree (per 16 leaves of it);
  * ``quant_ring_hop_leaves`` (the int8 payloads of a tree, with the
    exact hop of the old public copies fused in) -> one ``quant_mix``
    launch per tree (per 16 leaves); ``quant_ring_hop`` is its one-leaf
    case;
  * ``mix_wt`` (a realized per-round ``W_t``, the elastic engine's) ->
    one einsum per leaf and hop, no kernel;
  * ``quant_ring_hops_leaves`` (all-hop int8 of a tree) ->
    ``quantize_det`` per leaf, then one ``multi_hop_mix_quant`` launch for
    every hop of every leaf (per 16 leaves); ``quant_ring_hops`` is its
    one-leaf case.

The kernels read the ring neighbours by wrapped row index, so no rolled
copies are made.  Each is bitwise the JAX package's stacked expression (the
hop-by-hop ``quant_ring_hops`` included: every hop decodes the same int8
values).  The two-node ring keeps its own fp32 expression
(``gossip.mix_ring``), and dense topologies apply ``W^steps`` by einsum.
There is no ``shard_map`` counterpart: on one card every node row is local.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comms.compress import quantize_det
from repro_torch.kernels import ops
from repro_torch.tree import tree_flatten, tree_leaves, tree_map


def dense_power(spec, steps: int) -> np.ndarray:
    """``W^steps`` computed in float64 NumPy, once per call."""
    m = spec.matrix
    return np.linalg.matrix_power(m, steps) if steps > 1 else m


def ring_hops(tree, steps: int, self_weight: float):
    """``steps`` exact ring hops of a node-stacked tree: every leaf of more
    than two nodes through ONE grouped ring kernel call (``ring_mix_leaves``
    for one hop, ``multi_hop_mix_leaves`` for more); the two-node ring keeps
    ``gossip.mix_ring``'s expression."""
    from repro_torch.core import gossip as G
    if steps == 0:
        return tree
    wc = self_weight
    ws = (1.0 - wc) / 2.0
    leaves, unflatten = tree_flatten(tree)
    out, ring = list(leaves), []
    for j, x in enumerate(leaves):
        if x.shape[0] > 2:
            ring.append(j)
        else:
            out[j] = G.mix_ring(x, steps=steps, self_weight=wc)
    if ring:
        xs = [leaves[j] for j in ring]
        mixed = (ops.ring_mix_leaves(xs, w_self=wc, w_side=ws) if steps == 1
                 else ops.multi_hop_mix_leaves(xs, hops=steps, w_self=wc,
                                               w_side=ws))
        for j, m in zip(ring, mixed):
            out[j] = m
    return unflatten(out)


def _weights(spec) -> tuple[float, float]:
    wc = spec.self_weight
    return wc, (1.0 - wc) / 2.0


class StackedBackend:
    """Node axis = leaf axis 0 everywhere."""

    name = "stacked"

    def mix(self, spec, tree, steps: int):
        """Exact ``x <- W^steps x`` over a node-stacked tree."""
        if spec.n_nodes == 1 or steps == 0:
            return tree
        if spec.topology == "ring":
            return ring_hops(tree, steps, spec.self_weight)
        ws_np = dense_power(spec, steps)
        return tree_map(
            lambda x: torch.einsum(
                "ij,j...->i...",
                torch.as_tensor(ws_np, dtype=x.dtype, device=x.device), x),
            tree)

    def mix_hop(self, spec, tree):
        """One exact ``W`` hop."""
        return self.mix(spec, tree, steps=1)

    def mix_channel(self, spec, channel, tree, rnd: int, key, steps: int):
        """``steps`` hops through a :class:`~repro_torch.comms.channel.
        ChannelModel` (link drops / stragglers / schedules)."""
        return channel.mix(tree, rnd, key, steps=steps)

    def mix_wt(self, spec, tree, wt: torch.Tensor, *, steps: int = 1):
        """``steps`` hops of one realized (n, n) mixing matrix ``wt``
        (the elastic engine's ``W_t``), by einsum per leaf: the expression
        ``ChannelModel.mix_hop`` applies to a faulty round, so the two are
        bitwise equal whenever their matrices are.  No ring kernel: the
        weights differ per node."""
        for _ in range(max(steps, 0)):
            tree = tree_map(lambda x: torch.einsum(
                "ij,j...->i...", wt.to(x.dtype), x), tree)
        return tree

    def quant_ring_hop_leaves(self, spec, qs: list[torch.Tensor],
                              scales: list[torch.Tensor],
                              base: list[torch.Tensor] | None = None
                              ) -> list[torch.Tensor]:
        """Fused compressed ring hop of each int8 payload of ``qs`` (n, F)
        with its per-node scales (n, 1): ``wc*dq(q_i) + ws*(dq(q_{i-1}) +
        dq(q_{i+1}))``, fp32; with ``base`` (the old public copies, one fp32
        leaf of the payload's size each) the exact hop of the base is added:
        ``mix_hop(base) + that``, the first hop of error feedback.  One
        grouped ``quant_mix`` call for the tree (one launch per 16 leaves);
        a ring of n <= 2 keeps ``mix_hop``'s own expression for the base."""
        wc, ws = _weights(spec)
        if base is None or spec.n_nodes > 2:
            return ops.quant_mix_leaves(qs, scales, base=base, w_self=wc,
                                        w_side=ws)
        mixed = self.mix_hop(spec, list(base))
        return [m.reshape(w.shape) + w for m, w in zip(
            mixed, ops.quant_mix_leaves(qs, scales, w_self=wc, w_side=ws))]

    def quant_ring_hop(self, spec, q: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
        """:meth:`quant_ring_hop_leaves` of one leaf, without a base."""
        return self.quant_ring_hop_leaves(spec, [q], [scale])[0]

    def quant_ring_hops_leaves(self, spec, xs: list[torch.Tensor],
                               steps: int) -> list[torch.Tensor]:
        """``steps`` ring hops of each node-stacked leaf of ``xs`` (one
        mixed tree) where EVERY hop is int8-compressed: each hop
        requantizes its input deterministically and combines the decoded
        values.  Quantizing the leaves here is the first hop's
        requantization; one grouped kernel call runs all ``steps`` hops of
        every leaf."""
        if steps <= 0:
            return list(xs)
        n = xs[0].shape[0]
        qs, scales = [], []
        for x in xs:
            q, s = quantize_det(x)
            qs.append(q.reshape(n, -1))
            scales.append(s.reshape(n, 1))
        wc, ws = _weights(spec)
        zs = ops.multi_hop_mix_quant_leaves(qs, scales, hops=steps,
                                            w_self=wc, w_side=ws)
        return [z.reshape(x.shape).to(x.dtype) for z, x in zip(zs, xs)]

    def quant_ring_hops(self, spec, x: torch.Tensor,
                        steps: int) -> torch.Tensor:
        """:meth:`quant_ring_hops_leaves` of one leaf."""
        return self.quant_ring_hops_leaves(spec, [x], steps)[0]

    def est_hop_bytes(self, spec, tree) -> float:
        """Estimated bytes moved between nodes by one exact hop."""
        total = _tree_bytes(tree)
        if spec.topology == "ring":
            # every node row goes one slot in each direction
            return 2.0 * total
        # a dense mix reaches every other node
        return float(spec.n_nodes - 1) * total

    def est_quant_hop_bytes(self, spec, tree) -> float:
        """Estimated bytes moved by one int8-compressed hop of the
        ``quant_ring_hops`` schedule (int8 payload + f32 scale per row)."""
        total = _quant_tree_bytes(tree)
        if spec.topology == "ring":
            return 2.0 * total
        return float(spec.n_nodes - 1) * total

    def __repr__(self):
        return "StackedBackend()"


def _tree_bytes(tree) -> float:
    return float(sum(leaf.numel() * leaf.element_size()
                     for leaf in tree_leaves(tree)))


def _quant_tree_bytes(tree) -> float:
    """Bytes of one int8-compressed copy: 1 B/element + one f32 scale per
    node row (leaf axis 0)."""
    return float(sum(leaf.numel() + leaf.shape[0] * 4
                     for leaf in tree_leaves(tree)))


_STACKED = StackedBackend()


def resolve_backend(spec) -> StackedBackend:
    """The backend a ``GossipSpec`` routes through: the stacked one."""
    return _STACKED
