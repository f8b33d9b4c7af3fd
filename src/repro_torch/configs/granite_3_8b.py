"""Granite-3.0 8B base [dense] — GQA.  [hf:ibm-granite/granite-3.0-2b-base
family card]

40L  d_model=4096  32H (kv=8)  d_ff=12800  vocab=49155.

Values copied from the JAX package's ``configs/granite_3_8b.py``; its TPU
mesh plan has no counterpart on one card.
"""
from repro_torch.configs.base import (AttnSpec, BlockSpec, ModelConfig,
                                      uniform_stages)

_BLK = BlockSpec(kind="attn", attn=AttnSpec(kind="gqa"))

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    stages=uniform_stages(_BLK, 40),
    n_groups=8,
)

SMOKE = ModelConfig(
    name="granite-3-8b-smoke",
    family="dense",
    d_model=160,
    n_heads=8,
    n_kv_heads=2,
    head_dim=20,
    d_ff=320,
    vocab_size=256,
    stages=uniform_stages(_BLK, 2),
    n_groups=4,
    remat=False,
)
