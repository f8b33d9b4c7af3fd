"""Config schema of the port: the dataclasses the dense GQA path reads.

The port's own copy of the JAX package's ``configs/base.py`` (whose
package ``__init__`` imports JAX), cut to the fields the transformer, the
paged KV cache and the serving path read.  Field names, defaults and
meanings are the reference's.  Not carried over: the MoE, SSM and xLSTM
block specs, the modality frontend, the TPU mesh plan and the comms/perf
knobs; a block kind or attention flavour the port does not run yet is
refused where it is built (``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

BlockKind = Literal["attn", "moe_attn", "mamba", "mlstm", "slstm"]


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Attention flavour for one block."""
    kind: Literal["gqa", "mla"] = "gqa"
    sliding_window: Optional[int] = None      # None => full causal
    cross_attn: bool = False                  # adds a cross-attn sublayer


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: BlockKind = "attn"
    attn: Optional[AttnSpec] = None
    has_mlp: bool = True               # dense SwiGLU MLP after attention


@dataclasses.dataclass(frozen=True)
class Stage:
    blocks: tuple[BlockSpec, ...]      # one supercell
    repeat: int = 1                    # stacked repeats (leading axis R)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: Literal["dense", "moe", "hybrid", "vlm", "audio", "ssm"] = "dense"
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 2048
    vocab_size: int = 32000
    head_dim: int = 0                  # 0 => d_model // n_heads
    stages: tuple[Stage, ...] = ()
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    n_groups: int = 8                  # DRO group count (LM objective)
    remat: bool = True                 # activation checkpointing (training)
    vocab_pad_to: int = 0              # pad (un)embedding rows; 0 = none

    @property
    def padded_vocab(self) -> int:
        if self.vocab_pad_to <= 0:
            return self.vocab_size
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        return sum(len(s.blocks) * s.repeat for s in self.stages)


def uniform_stages(block: BlockSpec, n_layers: int) -> tuple[Stage, ...]:
    return (Stage(blocks=(block,), repeat=n_layers),)
