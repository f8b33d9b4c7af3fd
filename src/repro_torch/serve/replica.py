"""Replica groups: gossip weight sync across serving replicas
(``src/repro/serve/replica.py``).

N serving replicas hold copies of the weights that drift apart (per-replica
fine-tuning, merges, checkpoint pulls that straggle) and reconcile now and
then through the training stack's communication layer: EF-int8 CHOCO
gossip on the ring (``comms.layer.CommEngine`` with ``quant_hops="all"``).
With the default k = 2 a round is the fused first hop (one ``quant_mix``
launch for the tree, the exact hop of the old public copies fused in) and
one all-int8 tail hop (one ``multi_hop_mix_quant`` launch for the tree),
per 16 leaves of the tree.  Sync runs on a node-stacked copy of the
parameters, beside decode, not inside it.

Consistency is measured as training consensus is: the drift
``mean_i ||x_i - x̄|| / ||x̄||``, emitted as ``replica`` telemetry events
with the wire-byte counters of ``obs.wire``.  ``perturb`` draws its noise
from a ``torch.Generator`` seeded with ``seed + 1`` on the weights' device
(the JAX package draws with ``jax.random``, which the port cannot
reproduce; a test sets ``params`` from the same arrays on both sides).
"""
from __future__ import annotations

import torch

from repro_torch.comms.layer import CommEngine
from repro_torch.comms.spec import CommSpec
from repro_torch.core.gossip import GossipSpec
from repro_torch.obs import wire
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

SLOT = "serve"


class ReplicaGroup:
    """Node-stacked replica weights and one ``CommEngine`` sync path.
    ``draws`` is the engine's draw source of the quantization noise
    (default: ``GeneratorDraws`` seeded with ``seed``)."""

    def __init__(self, params, n_replicas: int, *, gamma: float = 0.9,
                 k_steps: int = 2, quant_hops: str = "all", seed: int = 0,
                 telemetry=None, draws=None):
        assert n_replicas >= 2, n_replicas
        self.n_replicas = n_replicas
        self.telemetry = telemetry
        comm = CommSpec(compressor="int8", error_feedback=True, gamma=gamma,
                        quant_hops=quant_hops, seed=seed)
        self.gossip = GossipSpec(topology="ring", n_nodes=n_replicas,
                                 k_steps=k_steps, comm=comm)
        self.engine = CommEngine(self.gossip, draws=draws)
        self.params = tree_map(
            lambda x: torch.stack([x] * n_replicas), params)
        device = tree_leaves(self.params)[0].device
        self.state = self.engine.init_state({SLOT: self.params})
        self.counters = wire.zero_counters(device)
        self.generator = torch.Generator(device=device).manual_seed(seed + 1)
        self._rnd = 0

    def replica(self, i: int):
        """Replica ``i``'s parameter tree (for a ``ServeEngine``)."""
        return tree_map(lambda x: x[i], self.params)

    def drift(self) -> float:
        """Consensus residual: ``mean_i ||x_i - x̄|| / ||x̄||``."""
        leaves = tree_flatten(self.params)[0]
        num = torch.zeros((self.n_replicas,), dtype=torch.float32,
                          device=leaves[0].device)
        den = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for leaf in leaves:
            mean = leaf.mean(dim=0)
            d = (leaf - mean).float()
            num = num + (d * d).sum(dim=tuple(range(1, leaf.ndim)))
            den = den + (mean.float() ** 2).sum()
        return float(torch.sqrt(num).mean()
                     / torch.clamp(torch.sqrt(den), min=1e-12))

    def perturb(self, scale: float) -> float:
        """Add independent per-replica Gaussian drift (divergent local
        updates); returns the drift after it."""
        leaves, unflatten = tree_flatten(self.params)
        self.params = unflatten([
            leaf + (torch.randn(leaf.shape, generator=self.generator,
                                device=leaf.device) * scale).to(leaf.dtype)
            for leaf in leaves])
        return self.drift()

    def sync(self, rounds: int = 1) -> list[float]:
        """``rounds`` EF-int8 gossip rounds (``k_steps`` hops each);
        returns the drift after each round and emits ``replica``
        events."""
        trace = []
        steps = self.gossip.k
        for _ in range(rounds):
            before = self.drift()
            mixed, state = self.engine.mix(self.state, SLOT, self.params,
                                           steps=steps, rnd=self._rnd)
            self.counters = wire.account_mix(
                self.counters, self.gossip, self.engine, self.engine.backend,
                self.state, SLOT, self.params, steps, self._rnd)
            self.params, self.state = mixed, state
            self._rnd += 1
            after = self.drift()
            trace.append(after)
            if self.telemetry is not None:
                self.telemetry.event("replica", {
                    "round": self._rnd, "steps": steps,
                    "drift_before": before, "drift_after": after,
                    **self.wire_stats()})
        return trace

    def wire_stats(self) -> dict:
        return wire.unpack(self.counters).as_dict()
