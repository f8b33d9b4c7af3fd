"""The stacked mix backend: node axis = axis 0 of every leaf, one card.

Mirrors ``StackedBackend.mix`` of ``src/repro/comms/backend.py``.  Ring
hops go through the port's kernels (``ops`` picks the CUDA kernel for a
tensor on the card, the plain version on the CPU):

  * ``steps == 1`` -> one ``ring_mix`` launch per leaf;
  * ``steps > 1``  -> one ``multi_hop_mix`` launch per leaf for all hops.

Both are bitwise the JAX package's ``mix_ring`` expression.  The two-node
ring keeps its own expression (``gossip.mix_ring``), and dense topologies
apply ``W^steps`` by einsum.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.tree import tree_map


def dense_power(spec, steps: int) -> np.ndarray:
    """``W^steps`` computed in float64 NumPy, once per call."""
    m = spec.matrix
    return np.linalg.matrix_power(m, steps) if steps > 1 else m


class StackedBackend:
    """Node axis = leaf axis 0 everywhere."""

    def mix(self, spec, tree, steps: int):
        from repro_torch.core import gossip as G
        if spec.n_nodes == 1 or steps == 0:
            return tree
        if spec.topology == "ring":
            if spec.n_nodes == 2:
                return G.mix_ring(tree, steps=steps,
                                  self_weight=spec.self_weight)
            wc = spec.self_weight
            ws = (1.0 - wc) / 2.0
            if steps == 1:
                return tree_map(
                    lambda x: ops.ring_mix(x, w_self=wc, w_side=ws), tree)
            return tree_map(
                lambda x: ops.multi_hop_mix(x, hops=steps, w_self=wc,
                                            w_side=ws), tree)
        ws_np = dense_power(spec, steps)
        return tree_map(
            lambda x: torch.einsum(
                "ij,j...->i...",
                torch.as_tensor(ws_np, dtype=x.dtype, device=x.device), x),
            tree)

    def __repr__(self):
        return "StackedBackend()"
