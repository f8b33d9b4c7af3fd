"""The comms engine: compressed, fault-tolerant gossip with error feedback.

Mirrors ``src/repro/comms/layer.py``.  ``CommEngine`` owns everything
between an optimizer's ``mix`` call and the wire.  One compressed gossip
round for a slot (``x``/``y``/``u``/``v``) is the CHOCO scheme:

    q_i      = C(x_i - x_hat_i)          # the only thing transmitted
    x_hat_i += q_i                       # every replica folds the payload
    x_i     += gamma * ([W_t^s x_hat]_i - x_hat_i)

With the identity compressor and ``gamma = 1`` this is ``x <- W^s x``.

The hop runs through :class:`~repro_torch.comms.channel.ChannelModel`
(drops / stragglers / schedules); a trivial channel takes the exact ring
path.  For int8 payloads on a clean ring the first hop is the fused
``quant_mix`` kernel: ``W(hat + dq(q)) = W hat + [dequantize + 3-way
combine of the int8 wire buffers]``, the exact hop of the old hats and the
int8 hop of a slot's tree in one grouped launch; under ``quant_hops="all"``
the k - 1 tail hops of the tree are one grouped ``multi_hop_mix_quant``
launch.

Randomness comes from the engine's draw source (``comms.compress``): the
round's keys are ``(slot, rnd)`` for quantization and ``(slot/chan, rnd)``
for the channel, stateless per round as the JAX package's ``fold_in``
derivation is.  Elastic membership is not ported.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.comms.backend import resolve_backend
from repro_torch.comms.channel import ChannelModel
from repro_torch.comms.compress import (DrawKey, GeneratorDraws,
                                        Int8Stochastic, compress_tree,
                                        make_compressor, tree_bits,
                                        tree_param_count)
from repro_torch.comms.spec import CommSpec
from repro_torch.tree import tree_flatten, tree_leaves, tree_map


class CommState(NamedTuple):
    """Per-node communication memory, carried in the optimizer state."""
    hats: dict            # CHOCO public copies, one tree per mixed slot
    # per-slot EMA of the compressor's empirical contraction delta
    # (E||C(r) - r||^2 <= (1 - delta)||r||^2); only tracked when
    # CommSpec.gamma_mode == "adaptive"
    deltas: Any = None


class CommEngine:
    """Static compression + channel machinery for one ``GossipSpec``.

    ``draws`` is the draw source of the quantization and channel noise
    (default: :class:`GeneratorDraws` seeded with ``CommSpec.seed``)."""

    def __init__(self, gossip, draws=None):
        comm: Optional[CommSpec] = gossip.comm
        if comm is None or not comm.enabled:
            raise ValueError("CommEngine requires an enabled GossipSpec.comm")
        self.gossip = gossip
        self.comm = comm
        self.compressor = make_compressor(comm)
        self.channel = ChannelModel.for_gossip(gossip, comm)
        self.backend = resolve_backend(gossip)
        self.draws = draws if draws is not None else GeneratorDraws(comm.seed)

    # -- state --------------------------------------------------------------

    def init_state(self, slots: dict) -> CommState:
        # channel-only configs never read the CHOCO memory
        hats = ({name: tree_map(torch.zeros_like, tree)
                 for name, tree in slots.items()}
                if self.comm.compressed else {})
        deltas = ({name: torch.ones((), dtype=torch.float32,
                                    device=tree_leaves(tree)[0].device)
                   for name, tree in slots.items()}
                  if self.comm.compressed and self.comm.adaptive_gamma
                  else None)
        return CommState(hats=hats, deltas=deltas)

    # -- accounting (static, pure Python over shapes) -----------------------

    def bits_per_mix(self, tree) -> float:
        return tree_bits(self.compressor, tree)

    def bits_per_param(self, tree) -> float:
        return tree_bits(self.compressor, tree) / max(tree_param_count(tree), 1)

    def wire_round_bytes(self, tree, steps: int) -> tuple[float, float]:
        """(wire, raw) bytes for one ``steps``-hop gossip round over a clean
        channel.  ``raw`` is ``steps`` full-precision hops; a compressed
        round ships the payload to every neighbour once (2 on a ring, n-1
        dense) plus ``steps - 1`` hat hops, int8 (+ per-row scales) under
        the all-hop schedule, full precision otherwise."""
        per_hop = self.backend.est_hop_bytes(self.gossip, tree)
        raw = float(steps) * per_hop
        if not self.comm.compressed:
            return raw, raw
        payload = tree_bits(self.compressor, tree) / 8.0
        fanout = 2.0 if self.gossip.topology == "ring" \
            else float(max(self.gossip.n_nodes - 1, 1))
        per_tail = per_hop
        if self.comm.quant_hops == "all" and self._use_fused_hop():
            per_tail = self.backend.est_quant_hop_bytes(self.gossip, tree)
        wire = fanout * payload + float(max(steps - 1, 0)) * per_tail
        return wire, raw

    def _keys(self, slot: str, rnd: int) -> tuple[DrawKey, DrawKey]:
        """(k_quant, k_chan) for one round of one slot."""
        return (DrawKey(self.draws, slot, int(rnd)),
                DrawKey(self.draws, f"{slot}/chan", int(rnd)))

    # -- one compressed gossip round ---------------------------------------

    def mix(self, state: CommState, slot: str, tree, *,
            steps: Optional[int] = None, rnd: int = 0):
        s = self.gossip.k if steps is None else steps
        if self.gossip.n_nodes == 1 or s == 0:
            return tree, state
        k_quant, k_chan = self._keys(slot, rnd)

        if not self.comm.compressed:
            # channel-only: full-precision payload over the faulty links
            return (self.backend.mix_channel(self.gossip, self.channel, tree,
                                             rnd, k_chan, steps=s), state)

        hat = state.hats[slot]
        ef = self.comm.error_feedback
        source = tree_map(lambda x, h: x - h, tree, hat) if ef else tree
        payload, wire = self._compress(k_quant, source)
        hat_new = tree_map(lambda h, p: h + p, hat, payload) if ef else payload
        mixed_hat = self._gossip_hats(hat_new, hat, wire, s, rnd, k_chan)
        gamma, deltas = self._gamma(state, slot, source, payload)
        mixed = tree_map(lambda x, mh, h: x + gamma * (mh - h),
                         tree, mixed_hat, hat_new)
        new_hats = dict(state.hats)
        new_hats[slot] = hat_new
        return mixed, CommState(hats=new_hats, deltas=deltas)

    def _gamma(self, state: CommState, slot: str, source, payload):
        """Consensus step size on the hats: the ``CommSpec.gamma`` constant,
        or (``adaptive``) an EMA of the observed contraction
        ``delta = 1 - ||C(r) - r||^2 / ||r||^2`` clipped to
        ``[gamma_min, 1]``."""
        if not self.comm.adaptive_gamma:
            return self.comm.gamma, state.deltas
        src, _ = tree_flatten(source)
        pay, _ = tree_flatten(payload)
        src_sq = sum(torch.sum(torch.square(leaf.float())) for leaf in src)
        err_sq = sum(torch.sum(torch.square((p - s).float()))
                     for p, s in zip(pay, src))
        obs = torch.clamp(1.0 - err_sq / (src_sq + 1e-30), 0.0, 1.0)
        ema = self.comm.gamma_ema
        delta = ema * state.deltas[slot] + (1.0 - ema) * obs
        gamma = torch.clamp(delta, self.comm.gamma_min, 1.0)
        deltas = dict(state.deltas)
        deltas[slot] = delta
        return gamma, deltas

    # -- internals ----------------------------------------------------------

    def _compress(self, key: DrawKey, tree):
        """Leaf-wise compression; for int8 also returns the raw wire buffers
        (q, scale) so the fused hop can consume them."""
        comp = self.compressor
        if isinstance(comp, Int8Stochastic):
            leaves, unflatten = tree_flatten(tree)
            qs, scales = zip(*(comp.quantize(key.fold_in(i), leaf)
                               for i, leaf in enumerate(leaves)))
            payload = unflatten([comp.dequantize(q, sc, leaf.dtype)
                                 for q, sc, leaf in zip(qs, scales, leaves)])
            return payload, (list(qs), list(scales))
        return compress_tree(comp, key, tree), None

    def _use_fused_hop(self) -> bool:
        return (self.comm.fuse_kernel and self.channel.trivial
                and self.gossip.topology == "ring"
                and isinstance(self.compressor, Int8Stochastic))

    def _gossip_hats(self, hat_new, hat_old, wire, s: int, rnd: int,
                     k_chan: DrawKey):
        if wire is not None and self._use_fused_hop():
            qs, scales = wire
            leaves_old, unflatten = tree_flatten(hat_old)
            n = leaves_old[0].shape[0]
            base = ([h.reshape(n, -1) for h in leaves_old]
                    if self.comm.error_feedback else None)
            # W hat_old + [dequantize + 3-way combine of the wire], one
            # grouped call for the tree
            outs = self.backend.quant_ring_hop_leaves(
                self.gossip, [q.reshape(n, -1) for q in qs],
                [sc.reshape(n, 1) for sc in scales], base)
            first = unflatten([o.reshape(like.shape).to(like.dtype)
                               for o, like in zip(outs, leaves_old)])
            if s <= 1:
                return first
            if self.comm.quant_hops == "all":
                # the tail hops stay on the int8 wire: every hop requantizes
                # deterministically, all of them in one launch per tree
                leaves_first, unflatten_first = tree_flatten(first)
                return unflatten_first(self.backend.quant_ring_hops_leaves(
                    self.gossip, leaves_first, s - 1))
            return self.backend.mix(self.gossip, first, steps=s - 1)
        return self.backend.mix_channel(self.gossip, self.channel, hat_new,
                                        rnd, k_chan, steps=s)


# ---------------------------------------------------------------------------
# optimizer shims
# ---------------------------------------------------------------------------


def maybe_engine(gossip, draws=None) -> Optional[CommEngine]:
    comm = getattr(gossip, "comm", None)
    if comm is not None and comm.enabled:
        return CommEngine(gossip, draws=draws)
    return None


def maybe_init_state(engine: Optional[CommEngine],
                     slots: dict) -> Optional[CommState]:
    return engine.init_state(slots) if engine is not None else None


def make_mixer(gossip, engine: Optional[CommEngine] = None,
               comm_state: Optional[CommState] = None, rnd: int = 0
               ) -> tuple[Callable[[str, Any, int], Any],
                          Callable[[], Optional[CommState]]]:
    """Slot-keyed mix router for one optimizer step.

    Returns ``(mix, finalize)``: ``mix(slot, tree, steps)`` routes through
    the comms engine when one is configured (threading the CommState) and
    through the backend's exact mix otherwise; ``finalize()`` yields the
    CommState to store in the next optimizer state."""
    box = {"cs": comm_state}
    exact = resolve_backend(gossip)

    def mix(slot: str, tree, steps: int):
        if engine is None:
            return exact.mix(gossip, tree, steps)
        out, box["cs"] = engine.mix(box["cs"], slot, tree, steps=steps,
                                    rnd=rnd)
        return out

    return mix, lambda: box["cs"]
