"""DeepSeek-V2 236B [moe] — MLA (kv_lora=512) + 160 routed experts top-6,
2 shared experts, first layer dense.  [arXiv:2405.04434]

60L  d_model=5120  128H  d_ff(expert)=1536  vocab=102400.

Values copied from the JAX package's ``configs/deepseek_v2_236b.py``; its
TPU mesh plan has no counterpart on one card.
"""
from repro_torch.configs.base import (AttnSpec, BlockSpec, ModelConfig,
                                      MoESpec, Stage)

_MLA = AttnSpec(kind="mla", q_lora_rank=1536, kv_lora_rank=512,
                qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128)
_MOE = MoESpec(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
               capacity_factor=1.25, router_aux_coef=0.003)

_FIRST = BlockSpec(kind="attn", attn=_MLA, has_mlp=True)        # dense layer 0
_MOE_BLOCK = BlockSpec(kind="moe_attn", attn=_MLA, moe=_MOE)

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=12288,                      # dense first-layer FFN
    vocab_size=102400,
    stages=(Stage(blocks=(_FIRST,), repeat=1),
            Stage(blocks=(_MOE_BLOCK,), repeat=59)),
    rope_theta=10000.0,
    n_groups=8,
)

_SMK_MLA = AttnSpec(kind="mla", q_lora_rank=64, kv_lora_rank=32,
                    qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32)
_SMK_MOE = MoESpec(n_experts=4, top_k=2, d_expert=64, n_shared=1,
                   capacity_factor=2.0)

SMOKE = ModelConfig(
    name="deepseek-v2-236b-smoke",
    family="moe",
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=256,
    stages=(Stage(blocks=(BlockSpec(kind="attn", attn=_SMK_MLA),), repeat=1),
            Stage(blocks=(BlockSpec(kind="moe_attn", attn=_SMK_MLA,
                                    moe=_SMK_MOE),), repeat=1)),
    n_groups=4,
    remat=False,
)
