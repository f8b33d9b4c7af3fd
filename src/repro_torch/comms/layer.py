"""Slot-keyed mix router of one optimizer step.

Mirrors the engine-less path of ``make_mixer`` in
``src/repro/comms/layer.py``: without a comms engine (compression, channel
faults and elastic membership are not ported yet) every slot's mix is the
backend's exact mix.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.comms.backend import StackedBackend


def make_mixer(gossip) -> Callable[[str, object, int], object]:
    """``mix(slot, tree, steps)``: W^steps of a node-stacked tree.  The
    slot name (x, y, u, v) is where a comms engine would keep per-slot
    state; the exact path ignores it."""
    exact = StackedBackend()

    def mix(slot: str, tree, steps: int):
        return exact.mix(gossip, tree, steps)

    return mix
