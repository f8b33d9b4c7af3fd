"""Deterministic synthetic data streams (NumPy, seeded).

The port's own copies of ``ClassificationStream`` and ``TokenStream`` from
``src/repro/data/synthetic.py``: the same seed gives the same batches,
byte for byte.  Gaussian-cluster images of ``n_classes`` classes stand in
for MNIST in the paper's fair-classification experiment; group-tagged
Zipf token sequences feed the group-DRO language-model objective.  Each
node over-samples a different class or group mixture, so the nodes' data
are heterogeneous.
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


@dataclasses.dataclass
class TokenStream:
    """Group-tagged token sequences: group g draws its tokens from a Zipf
    law over its own permutation of the vocabulary; node i draws each
    sequence's group from its own mixture.  ``batch(step)`` returns
    node-stacked ``{"tokens" (N, B, S) int32, "group_ids" (N, B) int32}``
    (``(N, B, S, CB)`` tokens with ``n_codebooks`` > 1)."""
    n_nodes: int
    batch_per_node: int
    seq_len: int
    vocab_size: int
    n_groups: int = 8
    n_codebooks: int = 1
    hetero: float = 0.7
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.mix = _node_group_mixture(self.n_nodes, self.n_groups,
                                       self.hetero, rng)
        # group g prefers a slice of the vocabulary (Zipf within slice)
        v = self.vocab_size
        self.group_probs = np.zeros((self.n_groups, v), np.float64)
        ranks = 1.0 / np.arange(1, v + 1)
        for g in range(self.n_groups):
            perm = np.random.default_rng((self.seed, 2, g)).permutation(v)
            self.group_probs[g, perm] = ranks
            self.group_probs[g] /= self.group_probs[g].sum()

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, 3, step))
        n, b, s = self.n_nodes, self.batch_per_node, self.seq_len
        gids = np.stack([
            rng.choice(self.n_groups, size=b, p=self.mix[i])
            for i in range(n)])
        shape = (n, b, s) if self.n_codebooks == 1 else \
            (n, b, s, self.n_codebooks)
        toks = np.empty(shape, np.int32)
        for i in range(n):
            for j in range(b):
                p = self.group_probs[gids[i, j]]
                toks[i, j] = rng.choice(self.vocab_size, size=shape[2:], p=p)
        return {"tokens": toks, "group_ids": gids.astype(np.int32)}
