"""Llama-3.2 11B Vision [vlm] — text decoder with cross-attention image
layers every 5th block; vision encoder STUBBED (precomputed patch
embeddings).  [hf:meta-llama/Llama-3.2-11B-Vision]

40L  d_model=4096  32H (kv=8)  d_ff=14336  vocab=128256.

Values copied from the JAX package's ``configs/llama_3_2_vision_11b.py``;
its TPU mesh plan has no counterpart on one card.
"""
from repro_torch.configs.base import (AttnSpec, BlockSpec, FrontendSpec,
                                      ModelConfig, patterned_stages)

_SELF = BlockSpec(kind="attn", attn=AttnSpec(kind="gqa"))
_XATTN = BlockSpec(kind="attn", attn=AttnSpec(kind="gqa", cross_attn=True))

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    # cross-attn every 5th layer; 40 = 5*8
    stages=patterned_stages([_SELF] * 4 + [_XATTN], 40),
    frontend=FrontendSpec(kind="vision", n_tokens=1600, embed_dim=1280),
    n_groups=8,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-11b-smoke",
    family="vlm",
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=256,
    stages=patterned_stages([_SELF, _XATTN], 2),
    frontend=FrontendSpec(kind="vision", n_tokens=16, embed_dim=48),
    n_groups=4,
    remat=False,
)
