"""SmolLM-135M [dense]: llama-architecture small model, the serving
path's default.  [hf:HuggingFaceTB/SmolLM-135M]

30L  d_model=576  9H (kv=3)  d_ff=1536  vocab=49152.

Values copied from the JAX package's ``configs/smollm_135m.py``; its TPU
mesh plan has no counterpart on one card.
"""
from repro_torch.configs.base import (AttnSpec, BlockSpec, ModelConfig,
                                      uniform_stages)

_BLK = BlockSpec(kind="attn", attn=AttnSpec(kind="gqa"))

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    stages=uniform_stages(_BLK, 30),
    n_groups=8,
)

SMOKE = ModelConfig(
    name="smollm-135m-smoke",
    family="dense",
    d_model=96,
    n_heads=3,
    n_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=256,
    stages=uniform_stages(_BLK, 2),
    n_groups=4,
    remat=False,
)
