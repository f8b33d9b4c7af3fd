"""Granite-3.0 1B-A400M base [moe] — 32 routed experts, top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]

24L  d_model=1024  16H (kv=8)  d_ff(expert)=512  vocab=49155.

Values copied from the JAX package's
``configs/granite_moe_1b_a400m.py``; its TPU mesh plan has no counterpart on one card.
"""
from repro_torch.configs.base import (AttnSpec, BlockSpec, ModelConfig,
                                      MoESpec, uniform_stages)

_BLK = BlockSpec(
    kind="moe_attn",
    attn=AttnSpec(kind="gqa"),
    moe=MoESpec(n_experts=32, top_k=8, d_expert=512, capacity_factor=1.25),
)

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    stages=uniform_stages(_BLK, 24),
    n_groups=8,
)

SMOKE = ModelConfig(
    name="granite-moe-1b-a400m-smoke",
    family="moe",
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=64,
    vocab_size=256,
    stages=uniform_stages(
        BlockSpec(kind="moe_attn", attn=AttnSpec(kind="gqa"),
                  moe=MoESpec(n_experts=4, top_k=2, d_expert=64,
                              capacity_factor=2.0)), 2),
    n_groups=4,
    remat=False,
)
