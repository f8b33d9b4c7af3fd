"""Elastic gossip: churn and staleness as an execution mode.

Mirrors ``src/repro/comms/elastic.py``.  :class:`~repro_torch.comms.channel.
ChannelModel` *simulates* link faults: every node still computes, and a
dropped link is a counterfactual on a static membership.  Here departures
and stragglers are real:

* a :class:`ChurnSchedule` (scripted timeline or seeded Markov draw) decides
  which nodes are **members** each round;
* sends to non-members are skipped and each dead link's weight folds back
  into the two endpoint diagonals, so every realized ``W_t`` stays symmetric
  doubly stochastic over the **live subgraph** (a departed node's row is
  exactly the identity row: it neither sends nor receives);
* a member that fails to publish a round (straggler) stays mixable for up to
  ``tau`` rounds through its **last-received buffer**; past ``tau`` the link
  is treated as dropped.  At ``tau = 0`` and full membership this is the
  channel model's drop semantics bit for bit (same draws, same mask
  algebra, same einsum);
* a (re)joining node is re-initialized from its live neighbours' mean
  (x/y slots, projected through the manifold map the optimizer registers)
  and from zeros (dual/tracking slots and the CHOCO hat memory).

:class:`Membership` rides in ``CommState.elastic``.  Its ``round`` is a
Python int and every mask a tensor on the state's device, so a round's
transition and mix queue device work and never wait on it.  In
**compressed** mode the CHOCO hats are the last-received public copies:
gating the hat fold by the publish mask gives stale-hop tolerance.

Draws come from draw sources (``comms.compress``): the churn from a source
seeded with ``ElasticSpec.seed``, stream ``elastic/churn`` at the round
(``sub("leave")`` and ``sub("join")``, one ``uniform((n,))`` each; a node
stays or comes where the uniform is below the rate, as
``jax.random.bernoulli`` decides); the faults from the engine's
``{slot}/chan`` stream at hop 0, ``sub("drop")`` then ``sub("straggle")``,
as ``ChannelModel`` draws them.  The elastic ``W_t`` is drawn once per
round and shared by its hops.  Every hop applies it by einsum
(``StackedBackend.mix_wt``): no ring kernel runs in an elastic round.

Elastic mode replaces the simulation channel: configure fault rates on
:class:`ElasticSpec`, not on ``CommSpec`` (mixing both raises).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.comms.compress import DrawKey, GeneratorDraws
from repro_torch.comms.layer import CommEngine, CommState
from repro_torch.comms.spec import CommSpec
from repro_torch.core.gossip import GossipSpec
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# churn schedules
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _scripted_timeline(events: tuple, n: int) -> np.ndarray:
    """Cumulative active-mask timeline (horizon+1, n) from (round, action,
    node) events; row t is the membership in force during round t, rows past
    the last event repeat it (the engine clamps the index)."""
    horizon = max(r for r, _, _ in events)
    tl = np.ones((horizon + 1, n), np.float32)
    cur = np.ones(n, np.float32)
    for t in range(horizon + 1):
        for r, action, node in events:
            if r == t:
                cur[node] = 0.0 if action == "leave" else 1.0
        tl[t] = cur
    return tl


@dataclasses.dataclass(frozen=True)
class ChurnSchedule:
    """Who is a member each round.

    ``static``   -- everyone, always.
    ``scripted`` -- an explicit event timeline ``((round, "leave"|"join",
    node), ...)``; membership is cumulative and repeats past the last event.
    ``random``   -- seeded per-round Markov draw: a member leaves with
    ``leave_rate``, a non-member rejoins with ``join_rate``; node 0 is
    pinned live so the subgraph never empties.
    """

    kind: str = "static"            # static | scripted | random
    events: tuple = ()              # ((round, "leave"|"join", node), ...)
    leave_rate: float = 0.0
    join_rate: float = 0.5

    def __post_init__(self):
        if self.kind not in ("static", "scripted", "random"):
            raise ValueError(f"unknown churn kind {self.kind!r}")
        object.__setattr__(self, "events", tuple(tuple(e)
                                                 for e in self.events))

    @property
    def enabled(self) -> bool:
        if self.kind == "scripted":
            return len(self.events) > 0
        return self.kind == "random"

    def active(self, prev: Tensor, rnd: int, key: DrawKey,
               timeline: Optional[Tensor] = None) -> Tensor:
        """Membership mask f32[n] in force during round ``rnd``, given the
        previous round's mask.  ``timeline``: the scripted timeline on
        ``prev``'s device (built from ``events`` when not given)."""
        n = prev.shape[0]
        if self.kind == "scripted" and self.events:
            if timeline is None:
                timeline = torch.as_tensor(
                    _scripted_timeline(self.events, n), device=prev.device)
            # a copy: the masks of two rounds are never one tensor
            return timeline[min(max(int(rnd), 0),
                                timeline.shape[0] - 1)].clone()
        if self.kind == "random":
            stay = (key.sub("leave").uniform((n,), prev.device)
                    < 1.0 - self.leave_rate).float()
            come = (key.sub("join").uniform((n,), prev.device)
                    < self.join_rate).float()
            act = torch.where(prev > 0, stay, come)
            act[0] = 1.0
            return act
        return prev


@dataclasses.dataclass(frozen=True)
class ElasticSpec:
    """Execution-mode config hung on ``GossipSpec.elastic``.

    ``tau`` is the stale-hop tolerance: a member that missed publishing for
    at most ``tau`` consecutive rounds keeps its links alive through its
    last-received buffer; ``tau = 0`` is the channel model's hard drop.
    ``drop_rate`` / ``straggler_rate`` are the execution-mode twins of the
    ``CommSpec`` simulation knobs.
    """

    churn: ChurnSchedule = ChurnSchedule()
    tau: int = 0
    drop_rate: float = 0.0
    straggler_rate: float = 0.0
    seed: int = 0

    @property
    def enabled(self) -> bool:
        return (self.churn.enabled or self.drop_rate > 0.0
                or self.straggler_rate > 0.0)


class Membership(NamedTuple):
    """Elastic state, in ``CommState.elastic``.

    ``round`` is the last round whose churn transition was committed: the
    first slot mixed in a round advances membership, later slots of the
    same round see the committed masks (one optimizer step mixes several
    slots against one ``CommState``).
    """

    round: int                      # -1 before the first round
    active: Tensor                  # f32[n] current membership mask
    prev_active: Tensor             # f32[n] previous round's mask
    staleness: dict                 # slot -> i32[n] rounds since publish
    stale: dict                     # slot -> last-published copy
    #                                 (uncompressed tau > 0 only;
    #                                 compressed mode reuses the hats)


class RoundView(NamedTuple):
    """Everything one (slot, round) realizes, derived in one place so the
    mix and the checks of ``W_t`` agree by construction."""

    active: Tensor                  # f32[n] committed membership
    prev: Tensor                    # f32[n] previous round's membership
    joined: Tensor                  # f32[n] 1 where a node joined this round
    publish: Tensor                 # f32[n] members that sent this round
    fresh: Tensor                   # f32[n] mixable endpoints (<= tau stale)
    link_mask: Tensor               # f32[n, n] symmetric realized link mask
    wt: Tensor                      # f32[n, n] realized mixing matrix
    staleness: Tensor               # i32[n] updated per-slot counters
    committed_round: int            # membership round watermark
    sched_live: Tensor              # scheduled undirected links, live pairs
    act_links: Tensor               # realized undirected links


def _bcast(v: Tensor, leaf: Tensor) -> Tensor:
    """A per-node vector shaped to broadcast over a stacked (n, ...) leaf."""
    return v.to(leaf.dtype).reshape(v.shape + (1,) * (leaf.ndim - 1))


class ElasticEngine(CommEngine):
    """``CommEngine`` whose gossip rounds run over a churning membership.

    ``draws``: one draw source for the churn and the faults (tests hand in
    the JAX package's draws, a replay hands in recorded ones); by default
    the faults draw from a source seeded with ``CommSpec.seed`` and the
    churn from one seeded with ``ElasticSpec.seed``."""

    def __init__(self, gossip, draws=None):
        es: Optional[ElasticSpec] = getattr(gossip, "elastic", None)
        if es is None or not es.enabled:
            raise ValueError("ElasticEngine requires an enabled "
                             "GossipSpec.elastic")
        comm = gossip.comm
        if comm is None or not comm.enabled:
            comm = CommSpec()          # uncompressed, clean, seed 0
        if comm.channel_active or comm.schedule != "static":
            raise ValueError(
                "elastic mode replaces the simulation ChannelModel: move "
                "drop_rate/straggler_rate onto ElasticSpec and keep "
                "CommSpec.schedule='static'")
        self.elastic = es
        self._setup(gossip, comm, draws)
        self.churn_draws = draws if draws is not None \
            else GeneratorDraws(es.seed)
        self._device_consts: dict = {}

    # the fused int8 hop bakes in clean static ring weights; elastic rounds
    # carry a per-round W_t, so they stay on the explicit-matrix path
    def _use_fused_hop(self) -> bool:
        return False

    def _consts(self, device) -> dict:
        """Per-device constants, built once: the base matrix, its
        off-diagonal part, the ring's neighbour mask and the scripted
        timeline."""
        device = torch.device(device)
        if device not in self._device_consts:
            n = self.gossip.n_nodes
            w = torch.as_tensor(self.gossip.matrix, dtype=torch.float32,
                                device=device)
            churn = self.elastic.churn
            self._device_consts[device] = {
                "off": w * (1.0 - torch.eye(n, dtype=torch.float32,
                                            device=device)),
                "sched": torch.as_tensor(self.channel._subset_masks[0],
                                         device=device),
                "timeline": (torch.as_tensor(
                    _scripted_timeline(churn.events, n), device=device)
                    if churn.kind == "scripted" and churn.events else None)}
        return self._device_consts[device]

    # -- state --------------------------------------------------------------

    def init_state(self, slots: dict) -> CommState:
        base = super().init_state(slots)
        n = self.gossip.n_nodes
        device = tree_leaves(slots)[0].device
        # distinct buffers, never aliases of the slots: the step replaces
        # tensors of the state, and a stale copy must not follow its slot
        staleness = {name: torch.zeros((n,), dtype=torch.int32,
                                       device=device) for name in slots}
        stale = ({name: tree_map(torch.clone, tree)
                  for name, tree in slots.items()}
                 if self.elastic.tau > 0 and not self.comm.compressed
                 else {})
        mem = Membership(round=-1,
                         active=torch.ones((n,), device=device),
                         prev_active=torch.ones((n,), device=device),
                         staleness=staleness, stale=stale)
        return base._replace(elastic=mem)

    # -- per-round realization ---------------------------------------------

    def round_view(self, state: CommState, slot: str, rnd: int) -> RoundView:
        """Commit (or replay) round ``rnd``'s membership transition and
        derive the slot's publish mask, freshness and realized ``W_t``.
        Pure: the same state, slot and round give the same view."""
        es: Membership = state.elastic
        spec = self.elastic
        n = self.gossip.n_nodes
        rnd = int(rnd)
        device = es.active.device
        consts = self._consts(device)

        # membership transition, committed once per round
        if rnd > es.round:
            active = spec.churn.active(
                es.active, rnd, DrawKey(self.churn_draws, "elastic/churn",
                                        rnd), consts["timeline"])
            prev, committed = es.active, rnd
        else:
            active, prev, committed = es.active, es.prev_active, es.round
        joined = active * (1.0 - prev)

        # per-slot fault draw: ChannelModel.mix's hop-0 key
        key = self._keys(slot, rnd)[1].fold_in(0)
        sched = consts["sched"]
        link = sched
        if spec.drop_rate > 0.0:
            keep = (key.sub("drop").uniform((n, n), device)
                    < 1.0 - spec.drop_rate).float()
            keep = torch.triu(keep, 1)
            link = sched * (keep + keep.T)
        up = torch.ones((n,), device=device)
        if spec.straggler_rate > 0.0:
            up = (key.sub("straggle").uniform((n,), device)
                  < 1.0 - spec.straggler_rate).float()

        publish = up * active
        staleness = torch.where(publish > 0,
                                torch.zeros_like(es.staleness[slot]),
                                es.staleness[slot] + 1)
        fresh = (staleness <= spec.tau).float() * active
        mask = link * (fresh[:, None] * fresh[None, :])

        w_off = consts["off"] * mask
        wt = w_off + torch.diag(1.0 - torch.sum(w_off, dim=1))

        live_pairs = sched * (active[:, None] * active[None, :])
        return RoundView(active=active, prev=prev, joined=joined,
                         publish=publish, fresh=fresh, link_mask=mask,
                         wt=wt, staleness=staleness,
                         committed_round=committed,
                         sched_live=torch.sum(live_pairs) / 2.0,
                         act_links=torch.sum(mask) / 2.0)

    def realized_wt(self, state: CommState, slot: str, rnd: int) -> Tensor:
        """The mixing matrix this slot's round-``rnd`` mix applies."""
        return self.round_view(state, slot, rnd).wt

    def link_stats(self, state: CommState, slot: str, rnd: int
                   ) -> tuple[Tensor, Tensor]:
        """(scheduled-live, realized) undirected link counts; dropped =
        scheduled-live - realized."""
        view = self.round_view(state, slot, rnd)
        return view.sched_live, view.act_links

    # -- join protocol ------------------------------------------------------

    def _reinit_joined(self, slot: str, tree, view: RoundView):
        """Replace just-joined nodes' rows: the mean of their live
        neighbours (of the previous round's membership) for primal slots,
        projected through the registered manifold map and falling back to
        the global live mean on an isolated join; zeros for dual/tracking
        slots.  Computed whether or not anyone joined (no host sync)."""
        joined = view.joined
        if slot not in self.manifolds and slot not in ("x", "y"):
            return tree_map(lambda z: z * (1.0 - _bcast(joined, z)), tree)

        wrow = self._consts(joined.device)["sched"] * view.prev[None, :]
        cnt = torch.sum(wrow, dim=1)
        g_cnt = torch.clamp(torch.sum(view.prev), min=1.0)

        def mean(leaf):
            num = torch.einsum("ij,j...->i...", wrow.to(leaf.dtype), leaf)
            g = torch.einsum("j,j...->...", view.prev.to(leaf.dtype),
                             leaf) / g_cnt.to(leaf.dtype)
            m = num / _bcast(torch.clamp(cnt, min=1.0), leaf)
            return torch.where(_bcast((cnt > 0).float(), leaf) > 0, m,
                               g[None])

        means = tree_map(mean, tree)
        mm = self.manifolds.get(slot)
        if mm is not None:
            from repro_torch.geometry import Manifold, as_manifold_map
            means = tree_map(lambda m, leaf: m.project(leaf),
                             as_manifold_map(mm), means,
                             is_leaf=lambda s: isinstance(s, Manifold))
        return tree_map(lambda z, m: torch.where(_bcast(joined, z) > 0, m, z),
                        tree, means)

    # -- one elastic gossip round ------------------------------------------

    def mix(self, state: CommState, slot: str, tree, *,
            steps: Optional[int] = None, rnd: int = 0):
        s = self.gossip.k if steps is None else steps
        if self.gossip.n_nodes == 1 or s == 0:
            return tree, state
        view = self.round_view(state, slot, rnd)
        es: Membership = state.elastic
        if self.elastic.churn.enabled:
            # skipped only by configuration: under a static membership
            # nobody ever joins, and the replacement is the identity
            tree = self._reinit_joined(slot, tree, view)

        new_staleness = dict(es.staleness)
        new_staleness[slot] = view.staleness
        new_stale = dict(es.stale)
        mem = Membership(round=view.committed_round, active=view.active,
                         prev_active=view.prev, staleness=new_staleness,
                         stale=new_stale)

        if not self.comm.compressed:
            if self.elastic.tau > 0 and slot in es.stale:
                pub = view.publish
                stale_old = es.stale[slot]
                d = torch.diagonal(view.wt)
                z = tree
                for _ in range(s):
                    # each endpoint contributes its published value when it
                    # sent this round, its last-received buffer otherwise;
                    # the self-weight always applies to the true local state
                    b = tree_map(lambda x, st: _bcast(pub, x) * x
                                 + (1.0 - _bcast(pub, x)) * st.to(x.dtype),
                                 z, stale_old)
                    mixed_b = self.backend.mix_wt(self.gossip, b, view.wt,
                                                  steps=1)
                    z = tree_map(lambda mb, x, bb: mb + _bcast(d, x) * (x - bb),
                                 mixed_b, z, b)
                new_stale[slot] = tree_map(
                    lambda st, x: torch.where(_bcast(pub, x) > 0, x,
                                              st.to(x.dtype)),
                    stale_old, tree)
                mixed = z
            else:
                mixed = self.backend.mix_wt(self.gossip, tree, view.wt,
                                            steps=s)
            return mixed, state._replace(elastic=mem)

        # compressed: the CHOCO hats double as the stale buffers.  A joining
        # node's hat resets to zero; only publishers fold a payload, so a
        # straggler's public copy stays put and keeps mixing until its links
        # age out of `fresh`.
        k_quant, _ = self._keys(slot, rnd)
        pub = view.publish
        hat_base = tree_map(lambda h: h * (1.0 - _bcast(view.joined, h)),
                            state.hats[slot])
        ef = self.comm.error_feedback
        source = tree_map(lambda x, h: x - h, tree, hat_base) if ef else tree
        payload, _ = self._compress(k_quant, source)
        upd = tree_map(lambda h, p: h + p, hat_base, payload) if ef \
            else payload
        hat_new = tree_map(
            lambda u, h: torch.where(_bcast(pub, u) > 0, u, h), upd, hat_base)
        mixed_hat = self.backend.mix_wt(self.gossip, hat_new, view.wt,
                                        steps=s)
        gamma, deltas = self._gamma(state, slot, source, payload)
        # inactive rows of W_t are identity rows, so mixed_hat == hat_new
        # there and departed nodes receive a zero consensus delta
        mixed = tree_map(lambda x, mh, h: x + gamma * (mh - h),
                         tree, mixed_hat, hat_new)
        new_hats = dict(state.hats)
        new_hats[slot] = hat_new
        return mixed, CommState(hats=new_hats, deltas=deltas, elastic=mem)



# ---------------------------------------------------------------------------
# the W_t contract (the JAX package's contracts.elastic_sweep_findings)
# ---------------------------------------------------------------------------

#: the churn schedules of the sweep, and its (tau, drop_rate,
#: straggler_rate) settings
SWEEP_SCHEDULES = {
    "static": ChurnSchedule(),
    "scripted": ChurnSchedule(kind="scripted", events=(
        (3, "leave", 1), (7, "leave", 4), (12, "join", 1), (20, "join", 4))),
    "random": ChurnSchedule(kind="random", leave_rate=0.2, join_rate=0.5),
}
SWEEP_FAULTS = ((0, 0.0, 0.3), (2, 0.2, 0.3))


def sweep_findings(churn: ChurnSchedule, tau: int = 0, drop_rate: float = 0.0,
                   straggler_rate: float = 0.0, *, n: int = 8,
                   rounds: int = 25, seed: int = 0, device="cpu",
                   tol: float = 1e-6) -> list[str]:
    """Every realized ``W_t`` of ``rounds`` rounds of an ``n``-node ring,
    with the real membership state threaded through :meth:`ElasticEngine.
    mix` round by round (the matrices a run applies): what is wrong with
    them, empty when each is exactly symmetric, has non-negative entries
    and rows and columns summing to 1 within ``tol``, and every departed
    node's row is exactly the identity row."""
    eng = ElasticEngine(GossipSpec(
        topology="ring", n_nodes=n, k_steps=1, elastic=ElasticSpec(
            churn=churn, tau=tau, drop_rate=drop_rate,
            straggler_rate=straggler_rate, seed=seed)))
    x = torch.ones((n, 4), device=device) * torch.arange(
        n, dtype=torch.float32, device=device)[:, None]
    state = eng.init_state({"x": x})
    eye = torch.eye(n, device=device)
    out = []
    for rnd in range(rounds):
        view = eng.round_view(state, "x", rnd)
        wt = view.wt
        if not torch.equal(wt, wt.T):
            out.append(f"round {rnd}: W_t is not symmetric")
        off = max(float((wt.sum(0) - 1).abs().max()),
                  float((wt.sum(1) - 1).abs().max()))
        if off > tol or float(wt.min()) < -tol:
            out.append(f"round {rnd}: W_t is not doubly stochastic "
                       f"(sums off by {off:.2e}, min {float(wt.min()):.2e})")
        gone = torch.nonzero(view.active == 0).flatten().tolist()
        for i in gone:
            if not torch.equal(wt[i], eye[i]):
                out.append(f"round {rnd}: departed node {i}'s row is not "
                           "the identity row")
        x, state = eng.mix(state, "x", x, steps=1, rnd=rnd)
    return out

