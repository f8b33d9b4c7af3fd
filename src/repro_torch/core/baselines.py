"""The paper's comparison baselines: Euclidean decentralized minimax methods
with each constrained leaf projected back onto its manifold.

Mirrors ``src/repro/core/baselines.py``:

* **GT-GDA** (Zhang et al. 2021): deterministic gradient-tracking GDA;
* **GNSD-A**: GT-GDA's skeleton fed stochastic minibatches;
* **DM-HSGD** (Xian et al. 2021): the hybrid (STORM) variance-reduced
  estimator, two gradient passes a step on the same batch;
* **GT-SRVR** (Zhang et al. 2021): SPIDER-style recursive variance
  reduction with gradient tracking and an anchor batch every ``q`` steps
  (:meth:`GTSRVR.anchor_step`; the training loop alternates).

Every method takes **Euclidean** gradients (no tangent projection), steps,
and projects each constrained leaf back onto its manifold with the
geometry's ``project`` (on Stiefel the polar factor a (a^T a)^{-1/2} by
Newton--Schulz, plain tensor products as in the JAX package).  Every mix is
one hop, whatever ``GossipSpec.k`` is, so an exact ring mixes each tree in
one grouped ``ring_mix`` call, and ``GossipSpec.comm`` routes the mixes
through the comms engine over the slots x, y, u and v, as in
``core/gda.py``.  The order of operations is the JAX package's.
Telemetry, the elastic engine's manifold registration and the jitted
``make_step`` are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.func import grad_and_value, vmap

from repro_torch.comms.layer import (CommState, make_mixer, maybe_engine,
                                     maybe_init_state)
from repro_torch.core.gda import (GDAHyper, StepMetrics, _consensus,
                                  _tree_consensus, _tree_mean_norm)
from repro_torch.core.gossip import GossipSpec
from repro_torch.core.minimax import MinimaxProblem
from repro_torch.tree import tree_map

Tensor = torch.Tensor


def _project_back(manifold_map, x: dict, method: str = "ns") -> dict:
    """Each leaf of ``x`` projected onto its manifold (identity on
    Euclidean leaves)."""
    return tree_map(lambda m, xi: m.project(xi, method=method),
                    manifold_map, x)


def _euclid_grads(problem: MinimaxProblem, x: dict, y: Tensor, batch: Any
                  ) -> tuple[Tensor, dict, Tensor]:
    """Per-node loss, grad_x and grad_y of node-stacked inputs: *Euclidean*
    gradients, no tangent projection."""
    (gx, gy), loss = vmap(grad_and_value(problem.loss_fn, argnums=(0, 1)))(
        x, y, batch)
    return loss, gx, gy


def _copy_tree(tree: dict) -> dict:
    return tree_map(torch.clone, tree)


def _metrics(loss, gx, gy, x, y, u) -> StepMetrics:
    return StepMetrics(
        loss=loss.mean(),
        grad_norm_x=_tree_mean_norm(gx),
        grad_norm_y=torch.linalg.vector_norm(
            gy.reshape(gy.shape[0], -1), dim=-1).mean(),
        consensus_x=_tree_consensus(x),
        consensus_y=_consensus(y),
        tracker_norm_u=_tree_mean_norm(u),
    )


class _Baseline:
    """What the four methods share: the problem, the gossip and the comms
    engine (``draws``: its draw source, as in ``DecentralizedGDA``)."""

    #: gossip steps of every mix
    k = 1

    def __init__(self, problem: MinimaxProblem, gossip: GossipSpec,
                 hyper, draws=None):
        self.problem, self.gossip, self.hyper = problem, gossip, hyper
        self.engine = maybe_engine(gossip, draws=draws)

    def _init_grads(self, x0: dict, y0: Tensor, batch0: Any):
        with torch.no_grad():
            _, gx, gy = _euclid_grads(self.problem, x0, y0, batch0)
        comm0 = maybe_init_state(self.engine,
                                 {"x": x0, "y": y0, "u": gx, "v": gy})
        return gx, gy, comm0

    def _mixer(self, state):
        return make_mixer(self.gossip, self.engine, state.comm, state.step)

    def _descend(self, mix, x: dict, y: Tensor, dx: dict, dy: Tensor, h
                 ) -> tuple[dict, Tensor]:
        """x <- project(W x - beta dx), y <- Proj_Y(W y + eta dy)."""
        x_new = tree_map(lambda mx, d: mx - h.beta * d, mix("x", x, 1), dx)
        x_new = _project_back(self.problem.manifold_map, x_new, h.invsqrt)
        y_new = self.problem.project_y(mix("y", y, 1) + h.eta * dy)
        return x_new, y_new


# ---------------------------------------------------------------------------
# GT-GDA / GNSD-A: gradient tracking descent ascent (+ projection)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GTState:
    x: dict
    y: Tensor
    u: dict
    v: Tensor
    gx_prev: dict
    gy_prev: Tensor
    step: int = 0
    comm: CommState | None = None


class GTGDA(_Baseline):
    """Euclidean gradient-tracking GDA with the projection back; fed full
    local datasets (GT-GDA).  GNSD-A is the same fed minibatches."""

    name = "gt-gda"
    deterministic = True

    def __init__(self, problem: MinimaxProblem, gossip: GossipSpec,
                 hyper: GDAHyper = GDAHyper(), draws=None):
        super().__init__(problem, gossip, hyper, draws)

    def init(self, x0: dict, y0: Tensor, batch0: Any) -> GTState:
        gx, gy, comm0 = self._init_grads(x0, y0, batch0)
        return GTState(x0, y0, gx, gy, _copy_tree(gx), gy.clone(), 0, comm0)

    @torch.no_grad()
    def step(self, state: GTState, batch: Any
             ) -> tuple[GTState, StepMetrics]:
        h = self.hyper
        mix, comm_final = self._mixer(state)
        x_new, y_new = self._descend(mix, state.x, state.y, state.u,
                                     state.v, h)
        loss, gx, gy = _euclid_grads(self.problem, x_new, y_new, batch)
        u_new = tree_map(lambda mu, g, gp: mu + g - gp,
                         mix("u", state.u, 1), gx, state.gx_prev)
        v_new = mix("v", state.v, 1) + gy - state.gy_prev
        new = GTState(x_new, y_new, u_new, v_new, gx, gy, state.step + 1,
                      comm_final())
        return new, _metrics(loss, gx, gy, x_new, y_new, u_new)


class GNSDA(GTGDA):
    """GNSD-A: GT-GDA's skeleton driven by stochastic minibatches."""

    name = "gnsd-a"
    deterministic = False


# ---------------------------------------------------------------------------
# DM-HSGD: hybrid stochastic gradient descent ascent (STORM estimator)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HSGDState:
    x: dict
    y: Tensor
    x_prev: dict
    y_prev: Tensor
    dx: dict       # STORM estimator of grad_x
    dy: Tensor
    step: int = 0
    comm: CommState | None = None


@dataclasses.dataclass(frozen=True)
class HSGDHyper:
    beta: float = 0.01
    eta: float = 0.05
    bx: float = 0.1      # STORM momentum for x
    by: float = 0.1
    invsqrt: str = "ns"


class DMHSGD(_Baseline):
    """DM-HSGD with the projection back.  STORM estimator
    d_t = g(w_t; B_t) + (1-b)(d_{t-1} - g(w_{t-1}; B_t)): both gradients on
    the same batch B_t."""

    name = "dm-hsgd"
    deterministic = False

    def __init__(self, problem: MinimaxProblem, gossip: GossipSpec,
                 hyper: HSGDHyper = HSGDHyper(), draws=None):
        super().__init__(problem, gossip, hyper, draws)

    def init(self, x0: dict, y0: Tensor, batch0: Any) -> HSGDState:
        gx, gy, comm0 = self._init_grads(x0, y0, batch0)
        return HSGDState(x0, y0, _copy_tree(x0), y0.clone(), gx, gy, 0,
                         comm0)

    @torch.no_grad()
    def step(self, state: HSGDState, batch: Any
             ) -> tuple[HSGDState, StepMetrics]:
        h = self.hyper
        mix, comm_final = self._mixer(state)
        loss, gx_cur, gy_cur = _euclid_grads(self.problem, state.x, state.y,
                                             batch)
        _, gx_old, gy_old = _euclid_grads(self.problem, state.x_prev,
                                          state.y_prev, batch)
        dx = tree_map(lambda g, go, d: g + (1.0 - h.bx) * (d - go),
                      gx_cur, gx_old, state.dx)
        dy = gy_cur + (1.0 - h.by) * (state.dy - gy_old)
        dx = mix("u", dx, 1)
        dy = mix("v", dy, 1)
        x_new, y_new = self._descend(mix, state.x, state.y, dx, dy, h)
        new = HSGDState(x_new, y_new, state.x, state.y, dx, dy,
                        state.step + 1, comm_final())
        return new, _metrics(loss, gx_cur, gy_cur, x_new, y_new, dx)


# ---------------------------------------------------------------------------
# GT-SRVR: SPIDER-style recursive variance reduction + gradient tracking
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SRVRState:
    x: dict
    y: Tensor
    x_prev: dict
    y_prev: Tensor
    gx_est: dict     # recursive estimator
    gy_est: Tensor
    u: dict          # gradient tracker on the estimator
    v: Tensor
    gx_est_prev: dict
    gy_est_prev: Tensor
    step: int = 0
    comm: CommState | None = None


@dataclasses.dataclass(frozen=True)
class SRVRHyper:
    beta: float = 0.01
    eta: float = 0.05
    q: int = 16          # anchor period (an anchor batch every q steps)
    invsqrt: str = "ns"


class GTSRVR(_Baseline):
    """GT-SRVR with the projection back.  :meth:`anchor_step` refreshes the
    estimator on an anchor batch; :meth:`step` applies the SPIDER recursion
    with same-batch gradient differences.  The training loop anchors every
    ``hyper.q`` steps.

    ``anchor_step`` stores one estimator as both ``gx_est`` and
    ``gx_est_prev`` (and so does ``step``): the same tensors, which is
    sound because nothing updates a state tensor in place."""

    name = "gt-srvr"
    deterministic = False

    def __init__(self, problem: MinimaxProblem, gossip: GossipSpec,
                 hyper: SRVRHyper = SRVRHyper(), draws=None):
        super().__init__(problem, gossip, hyper, draws)

    def init(self, x0: dict, y0: Tensor, anchor_batch: Any) -> SRVRState:
        gx, gy, comm0 = self._init_grads(x0, y0, anchor_batch)
        return SRVRState(x0, y0, _copy_tree(x0), y0.clone(), gx, gy,
                         _copy_tree(gx), gy.clone(), _copy_tree(gx),
                         gy.clone(), 0, comm0)

    def _update_params(self, state: SRVRState, gx_est: dict, gy_est: Tensor):
        h = self.hyper
        mix, comm_final = self._mixer(state)
        u_new = tree_map(lambda mu, g, gp: mu + g - gp,
                         mix("u", state.u, 1), gx_est, state.gx_est_prev)
        v_new = mix("v", state.v, 1) + gy_est - state.gy_est_prev
        x_new, y_new = self._descend(mix, state.x, state.y, u_new, v_new, h)
        return x_new, y_new, u_new, v_new, comm_final()

    @torch.no_grad()
    def anchor_step(self, state: SRVRState, anchor_batch: Any
                    ) -> tuple[SRVRState, StepMetrics]:
        loss, gx, gy = _euclid_grads(self.problem, state.x, state.y,
                                     anchor_batch)
        x_new, y_new, u_new, v_new, comm = self._update_params(state, gx, gy)
        new = SRVRState(x_new, y_new, state.x, state.y, gx, gy, u_new, v_new,
                        gx, gy, state.step + 1, comm)
        return new, _metrics(loss, gx, gy, x_new, y_new, u_new)

    @torch.no_grad()
    def step(self, state: SRVRState, batch: Any
             ) -> tuple[SRVRState, StepMetrics]:
        loss, gx_cur, gy_cur = _euclid_grads(self.problem, state.x, state.y,
                                             batch)
        _, gx_old, gy_old = _euclid_grads(self.problem, state.x_prev,
                                          state.y_prev, batch)
        gx_est = tree_map(lambda g, go, e: e + g - go,
                          gx_cur, gx_old, state.gx_est)
        gy_est = state.gy_est + gy_cur - gy_old
        x_new, y_new, u_new, v_new, comm = self._update_params(
            state, gx_est, gy_est)
        new = SRVRState(x_new, y_new, state.x, state.y, gx_est, gy_est,
                        u_new, v_new, gx_est, gy_est, state.step + 1, comm)
        return new, _metrics(loss, gx_cur, gy_cur, x_new, y_new, u_new)


ALL_BASELINES = {c.name: c for c in (GTGDA, GNSDA, DMHSGD, GTSRVR)}
