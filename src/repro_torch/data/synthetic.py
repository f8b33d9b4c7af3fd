"""Deterministic synthetic classification stream (NumPy, seeded).

The port's own copy of ``ClassificationStream`` from
``src/repro/data/synthetic.py``: the same seed gives the same batches.
Gaussian-cluster images of ``n_classes`` classes stand in for MNIST in the
paper's fair-classification experiment; each node over-samples a different
class mixture, so the nodes' data are heterogeneous.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _node_group_mixture(n_nodes: int, n_groups: int, hetero: float,
                        rng: np.random.Generator) -> np.ndarray:
    """Row-stochastic (n_nodes, n_groups): node i's sampling mixture."""
    base = np.full((n_nodes, n_groups), 1.0 / n_groups)
    pref = rng.dirichlet(np.full(n_groups, 0.3), size=n_nodes)
    return (1.0 - hetero) * base + hetero * pref


@dataclasses.dataclass
class ClassificationStream:
    n_nodes: int
    batch_per_node: int
    image_hw: int = 14
    channels: int = 1
    n_classes: int = 3
    hetero: float = 0.7
    noise: float = 0.6
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        d = self.image_hw * self.image_hw * self.channels
        self.means = rng.normal(size=(self.n_classes, d)).astype(np.float32)
        self.mix = _node_group_mixture(self.n_nodes, self.n_classes,
                                       self.hetero, rng)

    @property
    def input_dim(self) -> int:
        return self.image_hw * self.image_hw * self.channels

    def batch(self, step: int) -> dict:
        """Node-stacked {images (N,B,H,W,C), labels (N,B)}, deterministic."""
        rng = np.random.default_rng((self.seed, 1, step))
        n, b = self.n_nodes, self.batch_per_node
        labels = np.stack([
            rng.choice(self.n_classes, size=b, p=self.mix[i])
            for i in range(n)])
        eps = rng.normal(size=(n, b, self.input_dim)).astype(np.float32)
        x = self.means[labels] + self.noise * eps
        x = x.reshape(n, b, self.image_hw, self.image_hw, self.channels)
        return {"images": x, "labels": labels.astype(np.int32)}

    def full(self, n_batches: int = 4) -> dict:
        """A fixed 'full local dataset' for the deterministic methods."""
        bs = [self.batch(s) for s in range(n_batches)]
        return {k: np.concatenate([b[k] for b in bs], axis=1) for k in bs[0]}
