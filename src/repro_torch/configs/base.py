"""Config schema of the port: the dataclasses the GQA and MoE paths read.

The port's own copy of the JAX package's ``configs/base.py`` (whose
package ``__init__`` imports JAX), cut to the fields the transformer, the
MoE layer, the paged KV cache, the serving path, the LM objective and the
trainer read, and the Mamba2 block's :class:`SSMSpec`.  Field names,
defaults and meanings are the reference's.  The stubbed modality
frontend (:class:`FrontendSpec`, ``ModelConfig.frontend``) is carried
over: a model with one takes precomputed embeddings, which its
cross-attention layers read.  Not carried over: the xLSTM block spec,
the TPU-only fields (``mesh_plan``, ``use_scan``, ``dtype``), and
of :class:`MoESpec` the two knobs that only place the dispatch on a TPU
mesh (``dispatch_spmd_axis``, ``expert_shard_axis``; ``dispatch_groups``
stays: it sets the capacity per group, so it changes the numbers).  A
block kind the port does not run yet is refused where it is built
(``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Sequence

BlockKind = Literal["attn", "moe_attn", "mamba", "mlstm", "slstm"]


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Attention flavour for one block."""
    kind: Literal["gqa", "mla"] = "gqa"
    sliding_window: Optional[int] = None      # None => full causal
    cross_attn: bool = False                  # adds a cross-attn sublayer
    # MLA (DeepSeek-V2) dims, read when kind == "mla"
    q_lora_rank: int = 0                      # 0 => no q compression
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int = 8
    top_k: int = 2
    d_expert: int = 0                  # expert hidden dim (d_ff of one expert)
    n_shared: int = 0                  # always-on shared experts (DeepSeek-V2)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # dispatch tokens in G independent groups, capacity per group; -1 =
    # one group per sequence (the batch dim)
    dispatch_groups: int = 1


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    """Mamba2 (SSD) block."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: BlockKind = "attn"
    attn: Optional[AttnSpec] = None
    moe: Optional[MoESpec] = None      # the routed FFN of a "moe_attn" block
    ssm: Optional[SSMSpec] = None      # the Mamba2 mixer of a "mamba" block
    has_mlp: bool = True               # dense SwiGLU MLP (ignored for moe
    #                                    and mamba)


@dataclasses.dataclass(frozen=True)
class Stage:
    blocks: tuple[BlockSpec, ...]      # one supercell
    repeat: int = 1                    # stacked repeats (leading axis R)


@dataclasses.dataclass(frozen=True)
class FrontendSpec:
    """Stubbed modality frontend: the model takes precomputed embeddings
    (B, n_tokens, embed_dim), projected to d_model by ``frontend_proj``."""
    kind: Literal["vision", "audio_cond"] = "vision"
    n_tokens: int = 576                # image patch tokens / conditioning frames
    embed_dim: int = 1152              # frontend output dim (projected to d_model)


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
    n_codebooks: int = 1               # musicgen: 4 parallel EnCodec streams
    frontend: Optional[FrontendSpec] = None
    max_seq_len: int = 131072
    # which parameters are manifold-constrained: path-regex over '/'-joined
    # key paths; only matrix (and, for Stiefel, tall or square) matches are
    # constrained (``geometry.manifold_map_from_paths``)
    manifold_policy: str = (
        r"attn/(wq|wk|wv|wo|w_dq|w_dkv)$|mlstm/(wq|wk|wv|w_down)$")
    # the geometry of the policy-matched leaves: a repro_torch.geometry
    # registry name ("stiefel", "grassmann", "oblique", "sphere")
    manifold: str = "stiefel"
    n_groups: int = 8                  # DRO group count (LM objective)
    rho: float = 1.0                   # strong-concavity coefficient (Eq. 21)
    # activation checkpointing in the JAX package; the port keeps the
    # activations (the same numbers, more memory)
    remat: bool = True
    # correct-class logit by "gather" (take_along_axis) or "dot" (one-hot
    # contraction); the same loss
    ce_impl: str = "gather"
    vocab_pad_to: int = 0              # pad (un)embedding rows; 0 = none
    # --- communication layer knobs (repro_torch.comms) ---------------------
    comm_compressor: str = "none"      # "none" | "int8" | "topk" | "lowrank"
    comm_topk_frac: float = 0.05       # kept fraction per node (topk)
    comm_rank: int = 4                 # retained rank per matrix leaf
    comm_gamma: float = 0.9            # CHOCO consensus step on the hats
    comm_error_feedback: bool = True   # False => naive quantized gossip
    comm_quant_hops: str = "first"     # "first" | "all" (int8, k > 1)
    comm_drop_rate: float = 0.0
    comm_straggler_rate: float = 0.0
    comm_schedule: str = "static"      # static | round_robin | matching
    # how gossip hops execute: "stacked" (the node axis on leaf axis 0) or
    # "auto" (stacked without a mesh); "shard_map" is not ported
    mix_backend: str = "auto"

    def comm_spec(self):
        """``repro_torch.comms.CommSpec`` from the comm_* knobs, or None
        when the communication layer is a no-op (exact, lossless gossip)."""
        if (self.comm_compressor == "none" and self.comm_drop_rate == 0.0
                and self.comm_straggler_rate == 0.0
                and self.comm_schedule == "static"):
            return None
        from repro_torch.comms.spec import CommSpec
        return CommSpec(compressor=self.comm_compressor,
                        topk_frac=self.comm_topk_frac, rank=self.comm_rank,
                        gamma=self.comm_gamma,
                        error_feedback=self.comm_error_feedback,
                        quant_hops=self.comm_quant_hops,
                        drop_rate=self.comm_drop_rate,
                        straggler_rate=self.comm_straggler_rate,
                        schedule=self.comm_schedule)

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

    def flat_blocks(self) -> list[BlockSpec]:
        out: list[BlockSpec] = []
        for s in self.stages:
            out.extend(list(s.blocks) * s.repeat)
        return out


def uniform_stages(block: BlockSpec, n_layers: int) -> tuple[Stage, ...]:
    return (Stage(blocks=(block,), repeat=n_layers),)


def patterned_stages(cell: Sequence[BlockSpec], n_layers: int
                     ) -> tuple[Stage, ...]:
    """Repeat a supercell; a trailing partial cell becomes its own stage."""
    c = len(cell)
    full, rem = divmod(n_layers, c)
    stages = []
    if full:
        stages.append(Stage(blocks=tuple(cell), repeat=full))
    if rem:
        stages.append(Stage(blocks=tuple(cell[:rem]), repeat=1))
    return tuple(stages)
