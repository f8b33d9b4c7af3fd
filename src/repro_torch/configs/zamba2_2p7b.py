"""Zamba2 2.7B [hybrid]: a Mamba2 backbone with attention blocks.
[arXiv:2411.15242]

54L  d_model=2560  32H (kv=32)  hd=80  d_ff=10240  ssm_state=64
vocab=32000.

Values copied from the JAX package's ``configs/zamba2_2p7b.py``; its TPU
mesh plan has no counterpart on one card.  As there, the attention blocks
of the 5 Mamba2 : 1 attention supercell are nine separately stacked copies
(``patterned_stages``), not one set of weights shared by all nine.
"""
from repro_torch.configs.base import (AttnSpec, BlockSpec, ModelConfig,
                                      SSMSpec, patterned_stages)

_MAMBA = BlockSpec(kind="mamba",
                   ssm=SSMSpec(d_state=64, d_conv=4, expand=2, head_dim=64,
                               n_groups=1, chunk=256))
_ATTN = BlockSpec(kind="attn", attn=AttnSpec(kind="gqa"))

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    # 5 mamba : 1 attention supercell; 54 = 6 * 9
    stages=patterned_stages([_MAMBA] * 5 + [_ATTN], 54),
    n_groups=8,
)

SMOKE = ModelConfig(
    name="zamba2-2.7b-smoke",
    family="hybrid",
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=256,
    stages=patterned_stages(
        [BlockSpec(kind="mamba",
                   ssm=SSMSpec(d_state=8, head_dim=16, chunk=32)),
         _ATTN], 2),
    n_groups=4,
    remat=False,
)
