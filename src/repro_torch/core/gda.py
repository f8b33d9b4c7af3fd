"""DRGDA / DRSGDA: Algorithms 1 & 2 of Wu, Hu & Huang (AAAI 2023).

Mirrors ``src/repro/core/gda.py``.  One step updates every node i (axis 0
of every state leaf) at once:

  x_{t+1}^i = R_{x_t^i}( P_{T_x}( alpha * [W^k x_t]_i ) - beta * P_{T_x}(u_t^i) )
  y_{t+1}^i = Proj_Y( [W^k y_t]_i + eta * v_t^i )
  u_{t+1}^i = [W^k u_t]_i + grad_x f_i(x_{t+1}, y_{t+1}; B_{t+1})
                          - grad_x f_i(x_t,     y_t;     B_t)
  v_{t+1}^i = [W   v_t]_i + grad_y f_i(x_{t+1}, y_{t+1}; B_{t+1})
                          - grad_y f_i(x_t,     y_t;     B_t)

DRGDA passes each node's full local dataset every step (Alg. 1), DRSGDA a
fresh minibatch (Alg. 2).  As in the JAX package:

* ``u`` is mixed with W^k (step 6) but ``v`` with a single W hop (step 7);
* the tracker is mixed in ambient coordinates; the gradient entering it is
  tangent-projected once, at its own base point;
* ``GDAHyper.retraction="polar_fused"`` hands the AMBIENT direction
  ``alpha*[W^k x]_i - beta*u_i`` to the fused kernel, which projects it
  (the projection is linear and P_x(x) = 0);
* ``u``/``gx_prev`` start as distinct buffers.

The per-node gradients come from ``torch.func.vmap`` over
``torch.func.grad_and_value``; the Stiefel projections then run once on the
node-stacked gradients (one kernel launch per leaf for all nodes).
With ``GossipSpec.comm`` set, every mix runs through the comms engine
(``comms/layer.py``), whose memory rides ``GDAState.comm`` over the slots
x, y, u and v, and whose draws are keyed by the step.  With
``GossipSpec.elastic`` set, the engine is the elastic one
(``comms/elastic.py``), to which the optimizer registers the problem's
manifold map for the rejoin protocol.  With a ``telemetry``
(``repro_torch.obs.Telemetry``) every mix is counted into ``GDAState.obs``
(``obs/wire.py``) and the counters are flushed to the event log every
``flush_every`` steps, by the state's Python-int step; the counters never
touch the update, so a step with telemetry is bitwise the step without.
The JAX package's ``make_step``/``make_obs_step`` choose between jitted
executables, which an eager port does not have: ``step`` is the step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch.comms.backend import resolve_backend
from repro_torch.comms.layer import (CommState, make_mixer, maybe_engine,
                                     maybe_init_state)
from repro_torch.core.gossip import GossipSpec
from repro_torch.core.minimax import MinimaxProblem
from repro_torch.geometry import check_retraction_name, tangent_project_tree
from repro_torch.obs.wire import Counters, wrap_mixer
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GDAHyper:
    """Tuning parameters {alpha, beta, eta} of Algorithms 1/2."""
    alpha: float = 0.5          # consensus step size
    beta: float = 0.01          # descent step size for x
    eta: float = 0.05           # ascent step size for y
    # "polar" (paper default) | "qr" | "cayley" | "polar_fused" (the fused
    # kernel); resolved per leaf, Euclidean leaves use their own update
    retraction: str = "polar"
    invsqrt: str = "ns"         # "ns" (Newton-Schulz) | "eigh" (oracle)
    k_override: Optional[int] = None  # gossip steps; None -> GossipSpec.k


@dataclasses.dataclass
class GDAState:
    x: dict            # node-stacked min parameters (leaf axis 0 = node)
    y: Tensor          # node-stacked max variable, (n, ...)
    u: dict            # gradient tracker for x (ambient coords)
    v: Tensor          # gradient tracker for y
    gx_prev: dict      # last Riemannian grad_x (per node, own batch)
    gy_prev: Tensor    # last grad_y
    step: int = 0
    comm: CommState | None = None   # comms-engine memory (GossipSpec.comm)
    obs: Counters | None = None     # wire counters (with telemetry)


@dataclasses.dataclass
class StepMetrics:
    loss: Tensor                # mean local loss at (x_{t+1}, y_{t+1})
    grad_norm_x: Tensor         # mean ||grad_x f_i||
    grad_norm_y: Tensor
    consensus_x: Tensor         # mean_i ||x_i - x_bar||^2 (Euclidean, cheap)
    consensus_y: Tensor
    tracker_norm_u: Tensor


class DecentralizedGDA:
    """Shared engine for DRGDA (deterministic) and DRSGDA (stochastic)."""

    name = "gda"
    deterministic = True

    def __init__(self, problem: MinimaxProblem, gossip: GossipSpec,
                 hyper: GDAHyper = GDAHyper(), draws=None, telemetry=None):
        """``draws``: the comms engine's draw source (default: one seeded
        with ``gossip.comm.seed``); unused without ``gossip.comm``.
        ``telemetry``: a ``repro_torch.obs.Telemetry``, or None to run
        without counters."""
        self.problem = problem
        self.gossip = gossip
        self.hyper = hyper
        check_retraction_name(hyper.retraction)
        self.k = hyper.k_override if hyper.k_override is not None \
            else gossip.k
        self.backend = resolve_backend(gossip)
        self.engine = maybe_engine(gossip, draws=draws)
        if self.engine is not None:
            # the elastic join protocol projects a rejoining node's
            # consensus-mean x re-init through the problem's geometry
            self.engine.register_manifolds({"x": problem.manifold_map})
        self.telemetry = telemetry

    def init(self, x0: dict, y0: Tensor, batch0: Any) -> GDAState:
        """x0/y0 node-stacked; u_0 = grad_x f_i(x_0, y_0; B_0), v_0 likewise."""
        with torch.no_grad():
            _, rgx, gy = _vmapped_loss_and_rgrads(self.problem, x0, y0, batch0)
        comm0 = maybe_init_state(self.engine,
                                 {"x": x0, "y": y0, "u": rgx, "v": gy})
        obs0 = self.telemetry.init_counters(y0.device) \
            if self.telemetry else None
        return GDAState(x=x0, y=y0, u=rgx, v=gy,
                        gx_prev=tree_map(torch.clone, rgx),
                        gy_prev=gy.clone(), step=0, comm=comm0, obs=obs0)

    @torch.no_grad()
    def step(self, state: GDAState, batch: Any
             ) -> tuple[GDAState, StepMetrics]:
        h, k = self.hyper, self.k
        mix, comm_final = make_mixer(self.gossip, self.engine, state.comm,
                                     state.step)
        mix, obs_final = wrap_mixer(mix, state.obs, self.gossip, self.engine,
                                    self.backend, state.comm, state.step)

        # ---- step 4: Riemannian consensus + tracked descent on x ----------
        mixed_x = mix("x", state.x, k)

        def leaf_update(m, x, mx, u):
            kind = m.resolve_retraction(h.retraction)
            if kind == m.fused_retraction:
                return m.retract(x, h.alpha * mx - h.beta * u, kind)
            return m.descent_update(x, mx, u, alpha=h.alpha, beta=h.beta,
                                    kind=kind,
                                    **({"method": h.invsqrt}
                                       if kind == "polar" else {}))

        x_new = tree_map(leaf_update, self.problem.manifold_map,
                         state.x, mixed_x, state.u)

        # ---- step 5: Euclidean consensus + tracked ascent on y ------------
        y_new = self.problem.project_y(mix("y", state.y, k) + h.eta * state.v)

        # ---- steps 6/7: gradient tracking ----------------------------------
        loss_new, rgx_new, gy_new = _vmapped_loss_and_rgrads(
            self.problem, x_new, y_new, batch)
        u_new = tree_map(lambda mu, g, gp: mu + g - gp,
                         mix("u", state.u, k), rgx_new, state.gx_prev)
        v_new = mix("v", state.v, 1) + gy_new - state.gy_prev

        obs_new = flush_obs(self.telemetry, obs_final, state.step + 1)
        new_state = GDAState(x=x_new, y=y_new, u=u_new, v=v_new,
                             gx_prev=rgx_new, gy_prev=gy_new,
                             step=state.step + 1, comm=comm_final(),
                             obs=obs_new)
        metrics = StepMetrics(
            loss=loss_new.mean(),
            grad_norm_x=_tree_mean_norm(rgx_new),
            grad_norm_y=torch.linalg.vector_norm(
                gy_new.reshape(gy_new.shape[0], -1), dim=-1).mean(),
            consensus_x=_tree_consensus(x_new),
            consensus_y=_consensus(y_new),
            tracker_norm_u=_tree_mean_norm(u_new),
        )
        return new_state, metrics


class DRGDA(DecentralizedGDA):
    """Algorithm 1: deterministic decentralized Riemannian GDA.  Call
    :meth:`step` with each node's full local dataset every iteration."""
    name = "drgda"
    deterministic = True


class DRSGDA(DecentralizedGDA):
    """Algorithm 2: stochastic decentralized Riemannian GDA.  Call
    :meth:`step` with a fresh minibatch per node each iteration."""
    name = "drsgda"
    deterministic = False


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def flush_obs(telemetry, obs_final: Callable, step: int):
    """The step's final counters, flushed by ``telemetry`` (if any) as the
    counters of ``step``."""
    obs = obs_final()
    if telemetry is not None:
        telemetry.flush_counters(obs, step)
    return obs


def _vmapped_loss_and_rgrads(problem: MinimaxProblem, x: dict, y: Tensor,
                             batch: Any) -> tuple[Tensor, dict, Tensor]:
    """Per-node loss, Riemannian grad_x and grad_y of node-stacked inputs;
    the Stiefel leaves are projected by one grouped call."""
    (gx, gy), loss = vmap(grad_and_value(problem.loss_fn, argnums=(0, 1)))(
        x, y, batch)
    rgx = tangent_project_tree(problem.manifold_map, x, gx)
    return loss, rgx, gy


# shared with the baselines (core/baselines.py)
def _tree_mean_norm(tree) -> Tensor:
    sq = sum((leaf.reshape(leaf.shape[0], -1) ** 2).sum(-1)
             for leaf in tree_leaves(tree))
    return torch.sqrt(sq).mean()


def _consensus(x: Tensor) -> Tensor:
    xb = x.mean(0, keepdim=True)
    return ((x - xb).reshape(x.shape[0], -1) ** 2).sum(-1).mean()


def _tree_consensus(tree) -> Tensor:
    return sum(_consensus(leaf) for leaf in tree_leaves(tree))


def broadcast_to_nodes(tree, n: int):
    """Replicate single-node params to the node-stacked layout (every node
    starts from the same point), as contiguous copies."""
    return tree_map(lambda x: x.unsqueeze(0).expand(n, *x.shape).contiguous(),
                    tree)
