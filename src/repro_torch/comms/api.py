"""Typed facade of the comms subsystem: Protocols and the backend registry
(``src/repro/comms/api.py``).

Import-light (the standard library's ``typing`` only, no torch), so that
anything may type against these surfaces without importing the comms
machinery.  Three structural types:

* :class:`CommLike`     - the ``CommSpec`` surface the optimizers and the
  engine read (compression knobs and channel fault rates);
* :class:`ElasticLike`  - the ``ElasticSpec`` surface (churn, stale-hop
  tolerance ``tau``, the execution mode's fault rates);
* :class:`MixBackendProtocol` - how gossip hops execute;
  ``repro_torch.comms.backend.StackedBackend`` is the one the port has.

And the backend string registry: the ``mix_backend`` config knob and
``TrainSpec.mix_backend`` take a registered name, and
``repro_torch.comms.backend.make_backend`` constructs through
:data:`BACKENDS`.  ``comms/backend.py`` registers ``"stacked"`` (node
axis on leaf axis 0, one card) and ``"shard_map"``, whose factory raises
``NotImplementedError``: the backend over ``torch.distributed`` is
ROADMAP queue 1, item 7.
"""
from __future__ import annotations

from typing import Any, Callable, Protocol, runtime_checkable

__all__ = ["CommLike", "ElasticLike", "MixBackendProtocol", "BACKENDS",
           "register_backend", "backend_names"]


@runtime_checkable
class CommLike(Protocol):
    """What a ``GossipSpec.comm`` value must look like (see ``CommSpec``)."""

    compressor: str
    error_feedback: bool
    gamma: float
    drop_rate: float
    straggler_rate: float
    schedule: str
    seed: int

    @property
    def compressed(self) -> bool: ...

    @property
    def channel_active(self) -> bool: ...

    @property
    def enabled(self) -> bool: ...


@runtime_checkable
class ElasticLike(Protocol):
    """What a ``GossipSpec.elastic`` value must look like (see
    ``repro_torch.comms.elastic.ElasticSpec``)."""

    tau: int
    drop_rate: float
    straggler_rate: float
    seed: int

    @property
    def enabled(self) -> bool: ...


@runtime_checkable
class MixBackendProtocol(Protocol):
    """The strategy between the gossip arithmetic and the wire."""

    name: str

    def mix(self, spec: Any, tree: Any, steps: int) -> Any: ...

    def mix_hop(self, spec: Any, tree: Any) -> Any: ...

    def mix_channel(self, spec: Any, channel: Any, tree: Any, rnd: Any,
                    key: Any, steps: int) -> Any: ...

    def mix_wt(self, spec: Any, tree: Any, wt: Any, *,
               steps: int = 1) -> Any: ...

    def quant_ring_hop(self, spec: Any, q: Any, scale: Any, *args: Any,
                       **kwargs: Any) -> Any: ...

    def quant_ring_hops(self, spec: Any, x: Any, steps: int, *args: Any,
                        **kwargs: Any) -> Any: ...

    def est_hop_bytes(self, spec: Any, tree: Any) -> float: ...

    def est_quant_hop_bytes(self, spec: Any, tree: Any) -> float: ...


# ---------------------------------------------------------------------------
# backend string registry
# ---------------------------------------------------------------------------

#: name -> factory(mesh=None); filled by :mod:`repro_torch.comms.backend`
#: when it is imported, and open to more through :func:`register_backend`
#: (the JAX package's factories also take the shard_map backend's axis and
#: fusion knobs, which the port does not have)
BACKENDS: dict[str, Callable[..., Any]] = {}


def register_backend(name: str, factory: Callable[..., Any]) -> None:
    """Register a mix-backend factory under a config-string name."""
    BACKENDS[name] = factory


def backend_names() -> list[str]:
    return sorted(BACKENDS)
