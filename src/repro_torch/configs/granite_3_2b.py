"""Granite-3.0 2B base [dense] — GQA.  [hf:ibm-granite/granite-3.0-2b-base]

40L  d_model=2048  32H (kv=8)  d_ff=8192  vocab=49155.

Values copied from the JAX package's ``configs/granite_3_2b.py``; its TPU
mesh plan has no counterpart on one card.
"""
from repro_torch.configs.base import (AttnSpec, BlockSpec, ModelConfig,
                                      uniform_stages)

_BLK = BlockSpec(kind="attn", attn=AttnSpec(kind="gqa"))

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    stages=uniform_stages(_BLK, 40),
    n_groups=8,
)

SMOKE = ModelConfig(
    name="granite-3-2b-smoke",
    family="dense",
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=256,
    stages=uniform_stages(_BLK, 2),
    n_groups=4,
    remat=False,
)
