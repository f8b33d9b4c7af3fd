"""Numerical contract validators (``src/repro/analysis/contracts.py``):
doubly-stochastic W_t, manifold feasibility.

The paper's Theorem 1 rates (DRGDA O(eps^-2), DRSGDA O(eps^-4)) assume the
effective mixing matrix of every gossip round is symmetric doubly
stochastic, including rounds where the channel model
(``comms.channel.ChannelModel``) drops links or deactivates edges under a
round-robin or matching schedule, and every realized W_t of the elastic
execution mode.  The channel keeps this by folding dropped off-diagonal
weight back into the diagonal; these validators re-check it numerically
over seeded draws rather than trusting the construction.  The manifold
contract does the same for the geometry layer: every registered
manifold's retraction must land on the manifold from a random feasible
point and tangent direction, for every retraction it lists.

Every validator takes ``device`` (the card unless ``device="cpu"`` is
given): the W_t and the retractions are computed there (on the card, the
channel draws and ``"polar_fused"``'s kernel); the checks read them back
to the host.  The draws are the port's
(``comms.compress.GeneratorDraws`` and a ``torch.Generator``), not the
JAX package's.
"""
from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from repro_torch.analysis import Finding

__all__ = ["matrix_findings", "doubly_stochastic_findings",
           "channel_sweep_findings", "elastic_sweep_findings",
           "manifold_findings", "run"]


def matrix_findings(w: Any, *, where: str = "W", tol: float = 1e-5,
                    require_symmetric: bool = True) -> list[Finding]:
    """Check one mixing matrix: row and column sums 1, entries >= 0,
    symmetry."""
    findings = []
    if torch.is_tensor(w):
        w = w.detach().cpu().numpy()
    w = np.asarray(w)
    if w.ndim != 2 or w.shape[0] != w.shape[1]:
        return [Finding("doubly-stochastic", where,
                        f"not a square matrix: shape {w.shape}")]
    rows = np.abs(w.sum(axis=1) - 1.0)
    cols = np.abs(w.sum(axis=0) - 1.0)
    if rows.max() > tol:
        findings.append(Finding(
            "doubly-stochastic", where,
            f"row sums off by up to {rows.max():.2e} (tol {tol:.0e}); "
            "dropped link weight is not being folded back into the diagonal"))
    if cols.max() > tol:
        findings.append(Finding(
            "doubly-stochastic", where,
            f"column sums off by up to {cols.max():.2e} (tol {tol:.0e})"))
    if w.min() < -tol:
        findings.append(Finding(
            "doubly-stochastic", where,
            f"negative entry {w.min():.2e}: self-weight underflow "
            "(off-diagonal mass exceeds 1)"))
    if require_symmetric and np.abs(w - w.T).max() > tol:
        findings.append(Finding(
            "doubly-stochastic", where,
            f"asymmetric by {np.abs(w - w.T).max():.2e}; Theorem 1 needs "
            "symmetric W_t"))
    return findings


def doubly_stochastic_findings(channel: Any, *, rounds: int = 100,
                               seed: int = 0, tol: float = 1e-5,
                               where: str = "channel", max_report: int = 5,
                               device="cuda") -> list[Finding]:
    """Every effective W_t a channel draws over ``rounds`` seeded gossip
    rounds (``channel.w_t(rnd, key, device=device)``, the key round
    ``rnd`` of ``GeneratorDraws(seed)``) must stay symmetric doubly
    stochastic."""
    from repro_torch.comms.compress import DrawKey, GeneratorDraws
    findings = []
    draws = GeneratorDraws(seed)
    for rnd in range(rounds):
        w_t = channel.w_t(rnd, DrawKey(draws, "contract", rnd),
                          device=device)
        findings.extend(matrix_findings(
            w_t, where=f"{where} round {rnd}", tol=tol))
        if len(findings) >= max_report:
            findings.append(Finding(
                "doubly-stochastic", where,
                f"stopping after {max_report} findings ({rounds - rnd - 1} "
                "rounds unchecked)"))
            break
    return findings


def channel_sweep_findings(*, n: int = 8, rounds: int = 20, seed: int = 0,
                           tol: float = 1e-5, device="cuda") -> list[Finding]:
    """Topology x schedule x faults: every combination the comms layer
    supports must keep the effective W_t doubly stochastic."""
    from repro_torch.comms.channel import ChannelModel
    from repro_torch.core import gossip
    findings = []
    for topology in ("ring", "full", "torus", "star"):
        w = gossip.mixing_matrix(topology, n)
        findings.extend(matrix_findings(w, where=f"{topology}(n={n})",
                                        tol=tol))
        for schedule in ("static", "round_robin", "matching"):
            for drop, straggle in ((0.0, 0.0), (0.3, 0.0), (0.0, 0.3),
                                   (0.25, 0.25)):
                ch = ChannelModel(w, schedule=schedule, drop_rate=drop,
                                  straggler_rate=straggle, topology=topology)
                findings.extend(doubly_stochastic_findings(
                    ch, rounds=rounds, seed=seed, tol=tol, device=device,
                    where=f"{topology}/{schedule}/drop={drop}/"
                          f"strag={straggle}"))
    return findings


def elastic_sweep_findings(*, n: int = 8, rounds: int = 100, seed: int = 0,
                           tol: float = 1e-5, max_report: int = 5,
                           device="cuda") -> list[Finding]:
    """The elastic execution mode: every realized W_t, under scripted
    leave and rejoin, seeded random churn, stragglers and stale-hop
    tolerance, must stay symmetric doubly stochastic, and every departed
    node's row must be the identity row.  ``comms.elastic.
    sweep_findings`` threads the real membership state through
    ``ElasticEngine.mix`` round by round, so the matrices checked are the
    ones a training run applies; this runs it over its schedules
    (``SWEEP_SCHEDULES``) and fault settings (``SWEEP_FAULTS``)."""
    from repro_torch.comms import elastic
    findings = []
    for name, churn in elastic.SWEEP_SCHEDULES.items():
        for tau, drop, strag in elastic.SWEEP_FAULTS:
            where = f"elastic/{name}/tau={tau}/drop={drop}/strag={strag}"
            for msg in elastic.sweep_findings(
                    churn, tau, drop, strag, n=n, rounds=rounds, seed=seed,
                    device=device, tol=tol):
                findings.append(Finding("doubly-stochastic", where, msg))
            if len(findings) >= max_report:
                findings.append(Finding(
                    "doubly-stochastic", where,
                    f"stopping after {max_report} findings"))
                return findings
    return findings


def manifold_findings(*, seed: int = 0, d: int = 12, r: int = 4,
                      step: float = 0.1, tol: float = 1e-4,
                      names: Iterable[str] | None = None,
                      device="cuda") -> list[Finding]:
    """Every retraction of every registered manifold (``geometry.
    REGISTRY``, each retraction it lists in ``retractions``) must land on
    the manifold (``check()`` within ``tol``, finite) from a seeded
    feasible point and a tangent direction."""
    from repro_torch import geometry
    findings = []
    for i, name in enumerate(sorted(names or geometry.REGISTRY)):
        m = geometry.REGISTRY[name]
        gen = torch.Generator().manual_seed(seed * 1000 + i)
        x = m.rand(d, r, generator=gen, device=device)
        feas = float(m.check(x))
        if not np.isfinite(feas) or feas > tol:
            findings.append(Finding(
                "manifold-feasibility", f"{name}.rand",
                f"random point infeasible: check()={feas:.2e} (tol {tol:.0e})"))
            continue
        g = torch.randn(x.shape, generator=gen).to(device)
        u = m.tangent_project(x, g)
        for kind in m.retractions:
            y = m.retract(x, step * u, kind)
            resid = float(m.check(y))
            if not np.isfinite(resid) or resid > tol:
                findings.append(Finding(
                    "manifold-feasibility", f"{name}.retract[{kind}]",
                    f"retraction leaves the manifold: check()={resid:.2e} "
                    f"(tol {tol:.0e})"))
            if not bool(torch.isfinite(y).all()):
                findings.append(Finding(
                    "manifold-feasibility", f"{name}.retract[{kind}]",
                    "retraction produced non-finite entries"))
    return findings


def run(*, rounds: int = 20, device="cuda") -> list[Finding]:
    """All numerical contract validators, on ``device``."""
    return (channel_sweep_findings(rounds=rounds, device=device)
            + elastic_sweep_findings(device=device)
            + manifold_findings(device=device))
