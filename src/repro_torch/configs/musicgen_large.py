"""MusicGen-large [audio] — decoder-only transformer over 4 parallel
EnCodec codebook streams (embeddings summed, 4 output heads); the EnCodec
conv codec itself is the stubbed frontend per the carve-out.
[arXiv:2306.05284]

48L  d_model=2048  32H (kv=32)  d_ff=8192  vocab=2048 (codebook size).

Values copied from the JAX package's ``configs/musicgen_large.py``; its TPU
mesh plan has no counterpart on one card.
"""
from repro_torch.configs.base import (AttnSpec, BlockSpec, ModelConfig,
                                      uniform_stages)

_BLK = BlockSpec(kind="attn", attn=AttnSpec(kind="gqa"))

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    n_codebooks=4,
    stages=uniform_stages(_BLK, 48),
    n_groups=8,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    family="audio",
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=64,
    n_codebooks=4,
    stages=uniform_stages(_BLK, 2),
    n_groups=4,
    remat=False,
)
