"""Wire counters, threaded through an optimizer's state.

Mirrors ``src/repro/obs/wire.py``.  The optimizers thread the counters
through :func:`wrap_mixer`, which intercepts every ``mix(slot, tree,
steps)`` call and accumulates

* static accounting -- bytes per hop from the backend's ``est_hop_bytes``
  and, under a ``CommEngine``, the compressed-round bytes of
  ``CommEngine.wire_round_bytes`` (payload fan-out + exact hat hops);
* drawn accounting -- per-hop link activity under a faulty
  ``ChannelModel`` (``link_stats`` over the engine's channel key of the
  slot and round, ``CommEngine._keys``: the same draws the mix consumed)
  or an elastic round (``ElasticEngine.link_stats`` over the step's
  incoming ``CommState``, as the JAX package reads it).

Counters never feed back into the update math: a trajectory with
telemetry on is bitwise the one with telemetry off.

The JAX package threads one packed ``f32[6]`` device vector.  The port
runs eagerly, and a vector built from Python numbers on the card would be
a blocking host-to-device copy at every mix, so the leaf is split
(:class:`Counters`): ``host``, an ``f32[6]`` NumPy vector of every term
known from shapes (rounds, hops, bytes, and the link counts of a clean
channel), and ``drawn``, an ``f32[3]`` tensor on the state's device of the
terms read from the draws (wire bytes, active and dropped links), zero
until a mix draws.  The structure is the same whatever the gossip, so a
checkpoint of a state restores into any fresh state of its run.  Nothing
is read back to the host until :func:`pack` (a telemetry flush).  Both
halves accumulate in f32, one add per mix, as the JAX package's vector
does; within one run a field is either always static or always drawn, so
:func:`pack` adds a zero to every field and the packed vector holds the
JAX package's f32 sums.  Counts stay exact below 2**24.  The counters are
cumulative; readers difference consecutive flushes.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves

Tensor = torch.Tensor


class WireCounters(NamedTuple):
    """Host-side view of the packed counter vector (see :func:`unpack`)."""
    rounds: Any            # int -- mix() calls (one slot, any number of hops)
    hops: Any              # int -- gossip hops executed
    wire_bytes: Any        # float -- bytes actually put on the wire
    raw_bytes: Any         # float -- bytes a full-precision exchange would move
    active_links: Any      # float -- (link, hop) pairs that carried payload
    dropped_links: Any     # float -- scheduled (link, hop) pairs lost to faults

    def as_dict(self) -> dict:
        return {k: v for k, v in zip(self._fields, self)}


N_COUNTERS = len(WireCounters._fields)
_INT_FIELDS = ("rounds", "hops")
#: the fields a faulty channel or an elastic round draws, in ``drawn``
_DRAWN_FIELDS = (2, 4, 5)


class Counters(NamedTuple):
    """The port's counter leaf: the static terms on the host, the drawn
    terms on the device."""
    host: np.ndarray
    drawn: Tensor


def zero_counters(device="cpu") -> Counters:
    """Zero counters, the drawn terms on ``device`` (filled there: no
    copy from the host)."""
    return Counters(host=np.zeros((N_COUNTERS,), np.float32),
                    drawn=torch.zeros((len(_DRAWN_FIELDS),),
                                      dtype=torch.float32, device=device))


def pack(counters: Counters) -> np.ndarray:
    """The ``f32[6]`` vector, in ``WireCounters`` order; reads the drawn
    terms from the device (a sync)."""
    out = counters.host.copy()
    out[list(_DRAWN_FIELDS)] += counters.drawn.detach().cpu().numpy()
    return out


def unpack(counters) -> WireCounters:
    """:class:`Counters`, or a packed vector (NumPy, tensor or list), as
    the typed host view."""
    if isinstance(counters, Counters):
        vals = pack(counters)
    elif isinstance(counters, Tensor):
        vals = counters.detach().cpu().numpy()
    else:
        vals = np.asarray(counters)
    return WireCounters(*(
        int(v) if f in _INT_FIELDS else float(v)
        for f, v in zip(WireCounters._fields, vals)))


@functools.lru_cache(maxsize=64)
def static_link_count(spec) -> float:
    """Undirected edges of the topology graph (off-diagonal support of W);
    cached per (frozen, hashable) gossip spec: a mix asks for it every
    time."""
    w = np.asarray(spec.matrix)
    off = (w - np.diag(np.diag(w))) > 0
    return float(np.count_nonzero(off)) / 2.0


def account_mix(counters: Counters, gossip, engine, backend, comm_state,
                slot: str, tree, steps: int, rnd: int) -> Counters:
    """The counters after one ``mix(slot, tree, steps)`` call of round
    ``rnd``; ``comm_state`` is the step's incoming ``CommState``."""
    if gossip.n_nodes == 1 or steps == 0:
        return counters
    n_links = static_link_count(gossip)
    sched = float(steps) * n_links
    per_hop = backend.est_hop_bytes(gossip, tree)
    raw = float(steps) * per_hop
    drawn = counters.drawn

    if engine is None:
        wire, active, dropped = raw, sched, 0.0
    elif getattr(engine, "elastic", None) is not None:
        # elastic execution: only live links carry payload.  Re-derive the
        # round's realized link mask from the same round view the mix
        # consumed, count live-scheduled vs realized pairs, and scale the
        # wire estimate by the realized fraction of the static graph.
        wire, raw = engine.wire_round_bytes(tree, steps)
        sched_live, act = engine.link_stats(comm_state, slot, rnd)
        sched_live = sched_live * float(steps)
        act = act * float(steps)
        # divide by a tensor filled on the device (no copy): dividing by
        # a Python number may multiply by its reciprocal instead
        wire_t = wire * act / torch.full_like(
            act, max(float(steps) * n_links, 1.0))
        drawn = drawn + torch.stack([wire_t, act, sched_live - act]).to(
            torch.float32)
        wire, active, dropped = 0.0, 0.0, 0.0
    else:
        wire, raw = engine.wire_round_bytes(tree, steps)
        if engine.channel.trivial:
            active, dropped = sched, 0.0
        else:
            device = tree_leaves(tree)[0].device
            k_chan = engine._keys(slot, rnd)[1]
            sched_t = act_t = None
            for h in range(steps):
                s_h, a_h = engine.channel.link_stats(
                    rnd * steps + h, k_chan.fold_in(h), device)
                sched_t = s_h if sched_t is None else sched_t + s_h
                act_t = a_h if act_t is None else act_t + a_h
            # faulty links carry nothing: scale the wire estimate by the
            # realized active-link fraction (first-order, uniform links)
            wire_t = wire * act_t / torch.clamp(sched_t, min=1.0)
            drawn = drawn + torch.stack([wire_t, act_t, sched_t - act_t]
                                        ).to(torch.float32)
            wire, active, dropped = 0.0, 0.0, 0.0

    # one vector add per mix call (order = WireCounters._fields)
    host = counters.host + np.array(
        [1.0, steps, wire, raw, active, dropped], np.float32)
    return Counters(host=host, drawn=drawn)


def wrap_mixer(mix: Callable[[str, Any, int], Any],
               counters: Optional[Counters], gossip, engine, backend,
               comm_state, rnd: int
               ) -> tuple[Callable[[str, Any, int], Any],
                          Callable[[], Optional[Counters]]]:
    """Instrument a ``make_mixer`` mix function with wire accounting.

    Returns ``(mix2, counters_final)``; with ``counters is None`` the mix is
    returned untouched (telemetry off runs exactly the same code)."""
    if counters is None:
        return mix, lambda: None
    box = {"c": counters}

    def mix2(slot: str, tree, steps: int):
        out = mix(slot, tree, steps)
        box["c"] = account_mix(box["c"], gossip, engine, backend,
                               comm_state, slot, tree, steps, rnd)
        return out

    return mix2, lambda: box["c"]
