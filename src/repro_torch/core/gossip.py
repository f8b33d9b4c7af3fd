"""Gossip / consensus substrate of the port.

Mirrors ``src/repro/core/gossip.py``: the NumPy mixing matrices and the
Theorem-1 step count, the spec, and two plain mixing paths for the
node-stacked layout (node axis = axis 0 of every leaf):

* ``mix_dense``: arbitrary doubly-stochastic ``W`` by ``torch.einsum``;
* ``mix_ring``: the paper's ring, ``wc*x + ws*(roll(x, 1) + roll(x, -1))``
  per hop, with the degenerate two-node ring's own expression.

``GossipSpec.mix`` runs through the stacked backend
(:mod:`repro_torch.comms.backend`), which sends ring hops to the CUDA
kernels.  ``GossipSpec.comm`` (a :class:`~repro_torch.comms.spec.CommSpec`)
turns on the comms engine: compressed gossip with error feedback and a
faulty channel.  ``GossipSpec.elastic`` (a :class:`~repro_torch.comms.
elastic.ElasticSpec`) turns on the elastic execution mode: membership
churn, stale-hop tolerance and rejoin.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Literal, Optional

import numpy as np
import torch

from repro_torch.comms.spec import CommSpec
from repro_torch.tree import tree_map

if TYPE_CHECKING:
    from repro_torch.comms.elastic import ElasticSpec

Tensor = torch.Tensor
Topology = Literal["ring", "full", "torus", "star"]


# ---------------------------------------------------------------------------
# mixing matrices (numpy, built once at config time)
# ---------------------------------------------------------------------------


def ring_matrix(n: int, self_weight: float | None = None) -> np.ndarray:
    """Symmetric doubly-stochastic ring: each node averages itself and its
    two neighbours.  Default Metropolis weights => 1/3 each (n >= 3)."""
    if n == 1:
        return np.ones((1, 1))
    if n == 2:
        # degenerate ring: one neighbour, both "sides" are the same node
        wc = 0.5 if self_weight is None else self_weight
        return np.array([[wc, 1.0 - wc], [1.0 - wc, wc]])
    wc = self_weight if self_weight is not None else 1.0 / 3.0
    w_side = (1.0 - wc) / 2.0
    w = np.zeros((n, n))
    for i in range(n):
        w[i, i] = wc
        w[i, (i - 1) % n] = w_side
        w[i, (i + 1) % n] = w_side
    return w


def full_matrix(n: int) -> np.ndarray:
    return np.full((n, n), 1.0 / n)


def torus_matrix(rows: int, cols: int) -> np.ndarray:
    """2-D torus, Metropolis weights (degree 4)."""
    n = rows * cols
    w = np.zeros((n, n))
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            nbrs = [((r - 1) % rows) * cols + c, ((r + 1) % rows) * cols + c,
                    r * cols + (c - 1) % cols, r * cols + (c + 1) % cols]
            for j in set(nbrs) - {i}:
                w[i, j] = 1.0 / 5.0
            w[i, i] = 1.0 - w[i].sum()
    return w


def star_matrix(n: int) -> np.ndarray:
    """Star (centralized-like, for ablation): hub 0 <-> spokes."""
    w = np.zeros((n, n))
    for i in range(1, n):
        w[0, i] = w[i, 0] = 1.0 / n
        w[i, i] = 1.0 - 1.0 / n
    w[0, 0] = 1.0 - (n - 1) / n
    return w


def mixing_matrix(topology: Topology, n: int) -> np.ndarray:
    if topology == "ring":
        return ring_matrix(n)
    if topology == "full":
        return full_matrix(n)
    if topology == "star":
        return star_matrix(n)
    if topology == "torus":
        rows = int(math.sqrt(n))
        while n % rows:
            rows -= 1
        return torus_matrix(rows, n // rows)
    raise ValueError(f"unknown topology {topology!r}")


def second_largest_eigenvalue(w: np.ndarray) -> float:
    """lambda := second-largest |eigenvalue| of W (sets the spectral gap)."""
    ev = np.sort(np.abs(np.linalg.eigvalsh(w)))[::-1]
    return float(ev[1]) if len(ev) > 1 else 0.0


def required_gossip_steps(w: np.ndarray, n: int | None = None) -> int:
    """Paper's Theorem-1 prescription: k >= ceil( log_{lambda2} (1/(2 sqrt n)) ),
    i.e. k >= ln(2 sqrt n) / ln(1/lambda2)."""
    n = n or w.shape[0]
    lam = second_largest_eigenvalue(w)
    if lam <= 0.0:
        return 1
    return max(1, int(math.ceil(math.log(2.0 * math.sqrt(n))
                                / math.log(1.0 / lam))))


# ---------------------------------------------------------------------------
# plain mixing paths (node axis 0)
# ---------------------------------------------------------------------------


def mix_dense(w: Tensor, tree, steps: int = 1):
    """x <- W^steps x, arbitrary W, leading node axis on every leaf."""
    def leaf(x):
        for _ in range(steps):
            x = torch.einsum("ij,j...->i...", w.to(x.dtype), x)
        return x
    return tree_map(leaf, tree)


def mix_ring(tree, steps: int = 1, self_weight: float = 1.0 / 3.0):
    """Ring gossip, ``steps`` hops, as plain PyTorch.  Matches
    ``ring_matrix(n, self_weight)``; the association ``wc*x + ws*(l + r)``
    is the ring kernels' own, so the results agree bit for bit."""
    ws = (1.0 - self_weight) / 2.0

    def leaf(x):
        if x.shape[0] == 1:
            return x
        for _ in range(steps):
            if x.shape[0] == 2:  # degenerate ring: full side weight to the peer
                x = self_weight * x + (1.0 - self_weight) * x.roll(1, 0)
            else:
                x = self_weight * x + ws * (x.roll(1, 0) + x.roll(-1, 0))
        return x
    return tree_map(leaf, tree)


@dataclasses.dataclass(frozen=True)
class GossipSpec:
    """Static description of the communication graph."""
    topology: Topology = "ring"
    n_nodes: int = 16
    k_steps: int | None = None      # None => Theorem-1 prescription
    self_weight: float = 1.0 / 3.0
    # When set and enabled, the optimizers route mixing through
    # repro_torch.comms.layer.CommEngine (compression, channel faults)
    # instead of the exact paths.
    comm: Optional[CommSpec] = None
    # When set and enabled, mixing runs in the elastic execution mode
    # (repro_torch.comms.elastic.ElasticEngine): membership churn,
    # stale-hop tolerance, realized W_t over the live subgraph.
    elastic: Optional["ElasticSpec"] = None

    @property
    def matrix(self) -> np.ndarray:
        if self.topology == "ring":
            return ring_matrix(self.n_nodes, self.self_weight)
        return mixing_matrix(self.topology, self.n_nodes)

    @property
    def lam2(self) -> float:
        return second_largest_eigenvalue(self.matrix)

    @property
    def k(self) -> int:
        if self.k_steps is not None:
            return self.k_steps
        return required_gossip_steps(self.matrix, self.n_nodes)

    def mix(self, tree, steps: int | None = None):
        """Apply W^steps (default: the spec's k) to a node-stacked tree
        through the stacked backend."""
        from repro_torch.comms.backend import StackedBackend
        s = self.k if steps is None else steps
        return StackedBackend().mix(self, tree, s)
