"""Registered analysis passes of the port
(``src/repro/analysis/entrypoints.py``, its registry half).

A :class:`Pass` names the rules it checks and runs them on a device; the
CLI (``python -m repro_torch.analysis``) and the tests consume
:data:`PASSES`, ``--rules`` filtering by the rules each pass declares.
The port has two passes:

* ``kernels`` (``analysis/kernel_check.py``): oracle coverage and launch
  arithmetic on any device, the attention tile plans and the Hopper
  budgets on the card;
* ``contracts`` (``analysis/contracts.py``): doubly-stochastic W_t and
  manifold feasibility, computed on the device given.

Not ported yet (ROADMAP queue 1): the JAX package's jaxpr passes and their
rules (``weak-type-leak``, ``donation-miss``, ``effect-in-quiet-path``,
``comm-schedule``) and its recompile sentinel.

Adding a pass: write ``def pass_x(rules, device) -> list[Finding]``, and
append a :class:`Pass` row (its rules, and those of them that need a CUDA
card) to :data:`PASSES`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.analysis import Finding, contracts, kernel_check

__all__ = ["Pass", "PASSES", "run_passes", "selftest"]


def pass_kernels(rules: tuple, device) -> list[Finding]:
    return kernel_check.run(rules, device)


def pass_contracts(rules: tuple, device) -> list[Finding]:
    return [f for f in contracts.run(device=device) if f.rule in rules]


@dataclasses.dataclass(frozen=True)
class Pass:
    name: str
    rules: tuple          # the rules this pass checks (for --rules)
    fn: Callable          # fn(rules, device) -> list[Finding]
    card_rules: tuple = ()  # those of ``rules`` that read a CUDA card


PASSES = (
    Pass("kernels", kernel_check.RULES, pass_kernels,
         kernel_check.CARD_RULES),
    Pass("contracts", ("doubly-stochastic", "manifold-feasibility"),
         pass_contracts),
)


def run_passes(rules: set[str] | None = None, device="cuda"
               ) -> tuple[dict[str, list[Finding]], list[str]]:
    """Every pass whose declared rules meet ``rules`` (all when None), on
    ``device``.  Returns ({pass name: findings}, the rules not run, as
    ``"pass/rule"``: those that read a card, on another device)."""
    on_card = torch.device(device).type == "cuda"
    results, not_run = {}, []
    for p in PASSES:
        want = tuple(r for r in p.rules if rules is None or r in rules)
        if not on_card:
            not_run += [f"{p.name}/{r}" for r in want if r in p.card_rules]
            want = tuple(r for r in want if r not in p.card_rules)
        if want:
            results[p.name] = p.fn(want, device)
    return results, not_run


# ---------------------------------------------------------------------------
# selftest: seeded known-bad fixtures each rule must catch
# ---------------------------------------------------------------------------

# an ops.py whose ring-mix wrapper launches the kernel with no plain
# version beside it
_NO_PLAIN_VERSION = '''
from repro_torch.kernels import ring_mix as _rm
_KERNELS = {"ring_mix": (_rm, "launches")}


def ring_mix_leaves(xs, *, w_self, w_side):
    _record("ring_mix", lambda: [])
    return _rm.launch(xs, w_self, w_side)
'''

# an attention plan on the SIMT route that found no key tile
_NO_KEY_TILE = {"case": "selftest", "S": 7, "route": "simt", "rows": 8,
                "split": 0, "bytes": 0}

# a launch asking 16 bytes more shared memory than an H100 block may use
_OVER_SMEM = {"kernel": "selftest", "case": "over the limit", "regs": 64,
              "local_bytes": 0, "static_smem": 16, "dyn_smem": 232448,
              "threads": 256, "cluster": 1, "resident": 1}


class _LeakyChannel:
    """A channel whose faulty rounds leak row mass: the dropped weight is
    not folded into the diagonal."""

    def w_t(self, rnd, key, device="cpu"):
        from repro_torch.core.gossip import ring_matrix
        return torch.as_tensor(ring_matrix(4), dtype=torch.float32,
                               device=device) * 0.9


def selftest(device="cuda") -> list[str]:
    """Prove the rules fire: a wrapper source without a plain version, an
    attention plan without a key tile, a resources record over the
    shared-memory limit and a sub-stochastic W_t (on ``device``) must each
    produce a finding of their rule.
    Returns the failures (empty: every rule caught its fixture)."""
    failures = []
    found = kernel_check.check_oracle_coverage(source=_NO_PLAIN_VERSION)
    if not any(f.rule == "oracle-coverage" and "no plain version"
               in f.message for f in found):
        failures.append("oracle-coverage missed a launch with no plain "
                        "version")
    found = kernel_check.attention_tiling_findings([_NO_KEY_TILE], 232448)
    if not any(f.rule == "attention-tiling" for f in found):
        failures.append("attention-tiling missed a plan with no key tile")
    found = kernel_check.budget_findings([_OVER_SMEM], 232448)
    if not any(f.rule == "hopper-budget" and "shared memory" in f.message
               for f in found):
        failures.append("hopper-budget missed a launch over the shared-"
                        "memory limit")
    found = contracts.doubly_stochastic_findings(
        _LeakyChannel(), rounds=3, where="selftest", device=device)
    if not any(f.rule == "doubly-stochastic" for f in found):
        failures.append("doubly-stochastic missed a 0.9-scaled W_t")
    return failures
