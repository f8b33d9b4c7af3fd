"""Gemma-3 27B [dense] — GQA, 5:1 local:global sliding-window pattern, 128k
context.  [hf:google/gemma-3-1b-pt family card]

62L  d_model=5376  32H (kv=16)  d_ff=21504  vocab=262144.

Values copied from the JAX package's ``configs/gemma3_27b.py``; its TPU
mesh plan has no counterpart on one card.
"""
from repro_torch.configs.base import (AttnSpec, BlockSpec, ModelConfig,
                                      patterned_stages)

_LOCAL = BlockSpec(kind="attn", attn=AttnSpec(kind="gqa", sliding_window=1024))
_GLOBAL = BlockSpec(kind="attn", attn=AttnSpec(kind="gqa"))

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    # 5 local : 1 global supercell; 62 = 6*10 + 2
    stages=patterned_stages([_LOCAL] * 5 + [_GLOBAL], 62),
    rope_theta=1_000_000.0,
    max_seq_len=131072,
    n_groups=8,
)

SMOKE = ModelConfig(
    name="gemma3-27b-smoke",
    family="dense",
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=256,
    stages=patterned_stages(
        [BlockSpec(kind="attn", attn=AttnSpec(kind="gqa", sliding_window=8)),
         BlockSpec(kind="attn", attn=AttnSpec(kind="gqa"))], 2),
    n_groups=4,
    remat=False,
)
