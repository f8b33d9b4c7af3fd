"""Fault / time-variation model for one gossip hop.

Mirrors ``src/repro/comms/channel.py``.  ``ChannelModel`` turns one hop of
the fixed ``W`` into a sequence of effective matrices ``W_t`` built by

* **link drops** -- each active edge fails i.i.d. with ``drop_rate``;
* **straggler skips** -- each node sits a round out with ``straggler_rate``
  (it neither sends nor receives: all incident edges drop);
* **schedules** -- ``round_robin`` cycles the colour classes of a greedy
  proper edge colouring; ``matching`` samples one class per round.

Dropped weight folds back into the diagonal, so every ``W_t`` is symmetric
doubly stochastic.  The draws come from a :class:`~repro_torch.comms.
compress.DrawKey`: ``key.sub("drop")`` an (n, n) uniform (an edge is kept
where it is below ``1 - drop_rate``, as ``jax.random.bernoulli`` decides),
``key.sub("straggle")`` an (n,) uniform, ``key.sub("sched")`` one uniform
that picks the matching class.  A clean channel (no drops, no stragglers,
static schedule) takes the exact ring path, through the ring kernels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.comms.compress import DrawKey, GeneratorDraws
from repro_torch.comms.spec import CommSpec
from repro_torch.tree import tree_map

Tensor = torch.Tensor


def _edge_color_classes(w: np.ndarray) -> list[np.ndarray]:
    """Greedy proper edge colouring; returns per-colour symmetric 0/1 masks.
    Each class is a matching, so the ``matching`` schedule can sample
    classes directly."""
    n = w.shape[0]
    edges = [(i, j) for i in range(n) for j in range(i + 1, n) if w[i, j] > 0]
    colors: list[list[tuple[int, int]]] = []
    busy: list[set[int]] = []
    for i, j in edges:
        for c, nodes in enumerate(busy):
            if i not in nodes and j not in nodes:
                colors[c].append((i, j))
                nodes.update((i, j))
                break
        else:
            colors.append([(i, j)])
            busy.append({i, j})
    masks = []
    for cls in colors:
        m = np.zeros((n, n), np.float32)
        for i, j in cls:
            m[i, j] = m[j, i] = 1.0
        masks.append(m)
    return masks


@dataclasses.dataclass(frozen=True, eq=False)
class ChannelModel:
    """Seeded fault simulation over a base doubly-stochastic ``w``."""

    w: np.ndarray                  # base mixing matrix (n, n), numpy
    drop_rate: float = 0.0
    straggler_rate: float = 0.0
    schedule: str = "static"       # static | round_robin | matching
    topology: str = "ring"         # exact-path delegation hint
    self_weight: float = 1.0 / 3.0

    def __post_init__(self):
        if self.schedule == "static":
            masks = [(np.asarray(self.w) > 0).astype(np.float32)
                     * (1.0 - np.eye(self.w.shape[0], dtype=np.float32))]
        else:
            masks = _edge_color_classes(np.asarray(self.w))
        if not masks:  # edgeless graph (n == 1): W_t is the identity
            masks = [np.zeros_like(np.asarray(self.w, np.float32))]
        object.__setattr__(self, "_subset_masks", np.stack(masks))

    @classmethod
    def for_gossip(cls, gossip, comm: CommSpec) -> "ChannelModel":
        return cls(w=gossip.matrix, drop_rate=comm.drop_rate,
                   straggler_rate=comm.straggler_rate, schedule=comm.schedule,
                   topology=gossip.topology, self_weight=gossip.self_weight)

    # -- properties ---------------------------------------------------------

    @property
    def n(self) -> int:
        return self.w.shape[0]

    @property
    def n_subsets(self) -> int:
        return self._subset_masks.shape[0]

    @property
    def trivial(self) -> bool:
        return (self.drop_rate == 0.0 and self.straggler_rate == 0.0
                and self.schedule == "static")

    @property
    def lam2(self) -> float:
        from repro_torch.core.gossip import second_largest_eigenvalue
        return second_largest_eigenvalue(np.asarray(self.w))

    # -- per-round effective matrix ----------------------------------------

    def _round_masks(self, rnd: int, key: DrawKey, device="cpu"
                     ) -> tuple[Tensor, Tensor]:
        """(scheduled, effective) symmetric 0/1 link masks for round
        ``rnd``.  ``w_t`` and ``link_stats`` draw the same values for the
        same (rnd, key), so counted drops match applied drops."""
        n = self.n
        masks = torch.as_tensor(self._subset_masks, device=device)
        if self.schedule == "round_robin":
            sched = masks[rnd % self.n_subsets]
        elif self.schedule == "matching":
            u = key.sub("sched").uniform((), device)
            pick = torch.clamp((u * self.n_subsets).long(), max=self.n_subsets - 1)
            sched = masks[pick]
        else:
            sched = masks[0]
        mask = sched
        if self.drop_rate > 0.0:
            keep = (key.sub("drop").uniform((n, n), device)
                    < 1.0 - self.drop_rate).float()
            keep = torch.triu(keep, 1)
            mask = mask * (keep + keep.T)
        if self.straggler_rate > 0.0:
            up = (key.sub("straggle").uniform((n,), device)
                  < 1.0 - self.straggler_rate).float()
            mask = mask * (up[:, None] * up[None, :])
        return sched, mask

    def w_t(self, rnd: int, key: DrawKey, device="cpu") -> Tensor:
        """Effective mixing matrix for round ``rnd``; always symmetric
        doubly stochastic."""
        n = self.n
        w = torch.as_tensor(self.w, dtype=torch.float32, device=device)
        off = w * (1.0 - torch.eye(n, dtype=torch.float32, device=device))
        _, mask = self._round_masks(rnd, key, device)
        w_off = off * mask
        return w_off + torch.diag(1.0 - torch.sum(w_off, dim=1))

    def link_stats(self, rnd: int, key: DrawKey, device="cpu"
                   ) -> tuple[Tensor, Tensor]:
        """(scheduled, active) undirected link counts for round ``rnd``
        (dropped = scheduled - active), from the draws ``w_t`` uses."""
        sched, mask = self._round_masks(rnd, key, device)
        return torch.sum(sched) / 2.0, torch.sum(mask) / 2.0

    # -- mixing -------------------------------------------------------------

    def mix_hop(self, tree, rnd: int, key: DrawKey):
        """One gossip hop through the channel.  A trivial channel takes the
        exact path (the ring kernels for rings) and is bit-identical to it."""
        from repro_torch.comms.backend import ring_hops
        if self.trivial:
            if self.topology == "ring":
                return ring_hops(tree, 1, self.self_weight)
            return tree_map(lambda x: torch.einsum(
                "ij,j...->i...",
                torch.as_tensor(self.w, dtype=x.dtype, device=x.device), x),
                tree)
        wts: dict = {}

        def leaf(x):
            if x.device not in wts:
                wts[x.device] = self.w_t(rnd, key, x.device)
            return torch.einsum("ij,j...->i...", wts[x.device].to(x.dtype), x)

        return tree_map(leaf, tree)

    def mix(self, tree, rnd: int, key: DrawKey, steps: int = 1):
        for h in range(steps):
            tree = self.mix_hop(tree, rnd * steps + h, key.fold_in(h))
        return tree

    # -- diagnostics --------------------------------------------------------

    def empirical_mixing_rate(self, rounds: int = 64, seed: int = 0,
                              dim: int = 32) -> dict:
        """Per-round disagreement contraction under the sampled W_t
        sequence, to compare against the static-W ``lambda_2``."""
        draws = GeneratorDraws(seed)
        x = DrawKey(draws, "rate/x", 0).normal((self.n, dim), "cpu")
        err0 = float(torch.linalg.vector_norm(x - x.mean(0, keepdim=True)))
        errs = []
        for t in range(rounds):
            x = self.mix_hop(x, t, DrawKey(draws, "rate", t))
            errs.append(float(torch.linalg.vector_norm(
                x - x.mean(0, keepdim=True))))
        rate = (errs[-1] / err0) ** (1.0 / rounds) if err0 > 0 else 0.0
        return {"per_round_rate": rate, "lambda2_static": self.lam2,
                "final_over_initial": errs[-1] / max(err0, 1e-30)}
