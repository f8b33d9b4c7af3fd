"""Static description of the communication layer (compression + channel).

Mirrors ``src/repro/comms/spec.py``: a pure dataclass with no torch import,
so ``core.gossip`` can carry it as ``GossipSpec.comm``.  The runtime
machinery lives in :mod:`repro_torch.comms.compress`,
:mod:`repro_torch.comms.channel` and :mod:`repro_torch.comms.layer`.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

CompressorKind = Literal["none", "int8", "topk", "lowrank"]
Schedule = Literal["static", "round_robin", "matching"]


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """Everything between the optimizer and the wire, as static config.

    Compression (CHOCO-style): each node keeps a public copy ``x_hat`` of its
    state; one gossip round transmits ``C(x - x_hat)``, every replica folds
    the payload into its hats, and consensus steps on the hats with step size
    ``gamma``.  ``error_feedback=False`` drops the memory (naive quantized
    gossip, which plateaus at the compressor's noise floor; kept for
    ablation).

    Channel: one gossip hop may be perturbed by seeded i.i.d. link drops,
    straggler skips (a straggling node neither sends nor receives), and a
    time-varying edge schedule.  Dropped weight folds back into the diagonal
    so every effective ``W_t`` stays symmetric doubly stochastic.
    """
    # --- compression -------------------------------------------------------
    compressor: CompressorKind = "none"
    topk_frac: float = 0.05        # fraction of entries kept per node (topk)
    rank: int = 4                  # retained rank per matrix leaf (lowrank)
    error_feedback: bool = True    # CHOCO memory on/off
    gamma: float = 0.9             # consensus step size on the hats
    # "fixed" uses the ``gamma`` constant; "adaptive" tracks the compressor's
    # empirical contraction delta (EMA, per slot, in CommState.deltas) and
    # steps with it (CommEngine._gamma)
    gamma_mode: Literal["fixed", "adaptive"] = "fixed"
    gamma_ema: float = 0.9         # EMA smoothing of the observed delta
    gamma_min: float = 0.05        # floor on the adaptive step
    fuse_kernel: bool = True       # int8 ring hop through the quant_mix kernel
    # which hops of a multi-hop (k > 1) fused int8 round are compressed:
    # "first" ships C(x - x_hat) once then mixes the hats in fp32 (the
    # original CHOCO wire), "all" deterministically requantizes at EVERY hop
    # so int8 bytes are all that ever travel (the multi_hop_mix_quant kernel)
    quant_hops: Literal["first", "all"] = "first"
    # --- channel -----------------------------------------------------------
    drop_rate: float = 0.0         # per-edge i.i.d. Bernoulli drop probability
    straggler_rate: float = 0.0    # per-node i.i.d. skip probability
    schedule: Schedule = "static"  # edge activation schedule per round
    seed: int = 0                  # base seed for quantization + channel draws

    @property
    def compressed(self) -> bool:
        return self.compressor != "none"

    @property
    def adaptive_gamma(self) -> bool:
        return self.gamma_mode == "adaptive"

    @property
    def channel_active(self) -> bool:
        return (self.drop_rate > 0.0 or self.straggler_rate > 0.0
                or self.schedule != "static")

    @property
    def enabled(self) -> bool:
        return self.compressed or self.channel_active
