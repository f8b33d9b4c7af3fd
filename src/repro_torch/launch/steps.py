"""Step builders of the port (``src/repro/launch/steps.py``): the
decentralized LM trainer and the serving steps.

``build_trainer`` wires a ``ModelConfig`` into the paper's optimizer
stack: the group-DRO LM problem (``objectives/lm.py``) + ``GossipSpec`` +
DRGDA/DRSGDA (or a baseline).  ``init_train_state`` makes the node-stacked
start.  The JAX package's ``abstract_train_state`` (shape-only state for
the XLA dry run) has no counterpart: nothing here is compiled ahead.
``make_serve_step`` / ``make_prefill_step`` are the serving entry points.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.comms.backend import make_backend
from repro_torch.configs.base import ModelConfig
from repro_torch.core import OPTIMIZERS
from repro_torch.core.gda import GDAHyper, broadcast_to_nodes
from repro_torch.core.gossip import GossipSpec
from repro_torch.geometry import as_manifold_map
from repro_torch.models import transformer as T
from repro_torch.objectives import lm as lm_obj
from repro_torch.tree import tree_map

@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """One-object trainer config: every field mirrors the corresponding
    ``build_trainer`` keyword; ``comm`` overrides the config's
    ``comm_spec()`` when set, and ``elastic`` (a
    ``repro_torch.comms.elastic.ElasticSpec``) switches gossip into the
    elastic execution mode."""

    optimizer: str = "drsgda"
    topology: str = "ring"
    mix_backend: Optional[str] = None   # registry name; None => cfg knob
    comm: Any = None                    # CommSpec override; None => cfg
    elastic: Any = None                 # ElasticSpec or None
    telemetry: Any = None               # repro_torch.obs.Telemetry or None
    hyper: Optional[GDAHyper] = None


def build_trainer(cfg: ModelConfig, n_nodes: int,
                  spec: Optional[TrainSpec] = None, *,
                  optimizer: str = "drsgda",
                  hyper: Optional[GDAHyper] = None, topology: str = "ring",
                  mesh=None, mix_backend: Optional[str] = None,
                  telemetry=None, elastic=None):
    """Returns (opt, problem).  The default hyper takes k = 1 gossip step
    per mix (the paper's experimental regime).  Pass a :class:`TrainSpec`
    as ``spec`` (it wins over the keywords).

    The backend is constructed through the registry (``comms.api.
    BACKENDS``, by ``comms.backend.make_backend``) and handed to the
    optimizer in ``GossipSpec.backend``: ``"auto"`` and ``"stacked"`` give
    the stacked backend; a ``mesh`` or a ``mix_backend`` of ``"shard_map"``
    raises NotImplementedError (the backend over ``torch.distributed`` is
    ROADMAP queue 1, item 7), an unregistered name ValueError."""
    comm = None
    if spec is not None:
        optimizer, topology = spec.optimizer, spec.topology
        mix_backend, telemetry = spec.mix_backend, spec.telemetry
        comm, elastic, hyper = spec.comm, spec.elastic, spec.hyper
    kind = mix_backend if mix_backend is not None else cfg.mix_backend
    if mesh is not None and kind == "stacked":
        kind = "shard_map"       # a mesh asks for the backend over it
    backend = make_backend(kind, mesh=mesh)
    problem = lm_obj.make_lm_problem(cfg, T.abstract_params(cfg))
    gossip = GossipSpec(topology=topology, n_nodes=n_nodes, k_steps=1,
                        comm=comm if comm is not None else cfg.comm_spec(),
                        elastic=elastic, backend=backend)
    hyper = hyper or GDAHyper(alpha=0.5, beta=0.02, eta=0.05)
    opt = OPTIMIZERS[optimizer](problem, gossip, hyper, telemetry=telemetry)
    return opt, problem


def project_params_to_manifold(params: dict, map_or_mask) -> dict:
    """Every constrained leaf mapped to a feasible starting point by its
    geometry's ``feasible_init`` (Stiefel and Grassmann: QR; oblique and
    sphere: normalize; Euclidean: as it is); the port's copy of
    ``src/repro/sharding/partition.py`` ``project_params_to_manifold``."""
    return tree_map(lambda m, x: m.feasible_init(x),
                    as_manifold_map(map_or_mask), params)


def init_train_state(generator: Optional[torch.Generator], cfg: ModelConfig,
                     opt, n_nodes: int, batch0: dict, dtype=torch.float32,
                     params: Optional[dict] = None):
    """The optimizer's initial state: ``params`` (one node's, e.g. carried
    from the JAX package by ``repro_torch.convert``) or, without them,
    parameters drawn with ``generator`` on its device; projected onto the
    manifold, broadcast to ``n_nodes`` nodes, y uniform on the simplex.
    ``batch0`` is a node-stacked batch (``objectives.lm``): tokens, group
    ids and, for a model with a frontend, ``frontend_embeds``."""
    if params is None:
        params = T.init_params(generator, cfg, dtype)
    params = project_params_to_manifold(params, opt.problem.manifold_map)
    x0 = broadcast_to_nodes(params, n_nodes)
    device = next(iter(x0.values())).device
    y0 = lm_obj.init_y(cfg, n_nodes, device)
    return opt.init(x0, y0, batch0)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def make_serve_step(cfg: ModelConfig):
    """One-token decode against per-layer caches (written in place):
    ``serve_step(params, token, position, cache, frontend_embeds=None) ->
    (logits, cache)``; with codebooks, token (B, CB) and logits
    (B, CB, V)."""
    def serve_step(params, token, position, cache, frontend_embeds=None):
        return T.decode_step(params, cfg, token, position, cache,
                             frontend_embeds=frontend_embeds)
    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """Full-sequence prefill: ``prefill_step(params, tokens,
    frontend_embeds=None) -> (final-position logits, caches)``; tokens
    (B, S) or (B, S, CB)."""
    def prefill_step(params, tokens, frontend_embeds=None):
        logits, _, caches = T.forward(params, cfg, tokens,
                                      frontend_embeds=frontend_embeds,
                                      mode="prefill", last_logits_only=True)
        return logits[:, -1], caches
    return prefill_step
