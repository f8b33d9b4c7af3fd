"""Static and numerical checks of the port (``src/repro/analysis``).

Ported: :mod:`~repro_torch.analysis.contracts`, the numerical contracts
(doubly-stochastic W_t of every channel and elastic round, feasibility of
every registered manifold's retractions); :mod:`~repro_torch.analysis.
kernel_check` (oracle coverage, launch arithmetic, the Hopper budgets of
every CUDA kernel); the pass registry :mod:`~repro_torch.analysis.
entrypoints` and the CLI ``python -m repro_torch.analysis``; and the
:class:`Finding` record every validator returns.  The JAX package's jaxpr
lint (``jaxpr_lint``) and the passes that run it are ROADMAP queue 1.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Finding:
    """One rule violation, printable as ``[rule] where: message``."""

    rule: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.where}: {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)
