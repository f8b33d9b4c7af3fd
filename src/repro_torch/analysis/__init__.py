"""Static and numerical checks of the port (``src/repro/analysis``).

Ported so far: :mod:`~repro_torch.analysis.contracts`, the numerical
contracts (doubly-stochastic W_t of every channel and elastic round,
feasibility of every registered manifold's retractions), and the
:class:`Finding` record its validators return.  The JAX package's jaxpr
lint, kernel check, entry-point passes and CLI (``jaxpr_lint``,
``kernel_check``, ``entrypoints``, ``__main__``) are ROADMAP queue 1,
item 8.
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
