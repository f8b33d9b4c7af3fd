"""xLSTM 1.3B [ssm]: mLSTM blocks with an sLSTM block every 8th (the
paper's mixed-cell ratio).  [arXiv:2405.04517]

48L  d_model=2048  4H  d_ff=0 (the cells carry their own projections)
vocab=50304.

Values copied from the JAX package's ``configs/xlstm_1p3b.py``; its TPU
mesh plan has no counterpart on one card.
"""
from repro_torch.configs.base import (BlockSpec, ModelConfig, XLSTMSpec,
                                      patterned_stages)

_XS = XLSTMSpec(proj_factor=2.0, conv_window=4, chunk=256)
_M = BlockSpec(kind="mlstm", xlstm=_XS)
_S = BlockSpec(kind="slstm", xlstm=_XS)

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    # 7 mLSTM : 1 sLSTM supercell; 48 = 8 * 6
    stages=patterned_stages([_M] * 7 + [_S], 48),
    n_groups=8,
)

_XS_SMK = XLSTMSpec(proj_factor=2.0, conv_window=4, chunk=32)

SMOKE = ModelConfig(
    name="xlstm-1.3b-smoke",
    family="ssm",
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=256,
    stages=patterned_stages(
        [BlockSpec(kind="mlstm", xlstm=_XS_SMK),
         BlockSpec(kind="slstm", xlstm=_XS_SMK)], 2),
    n_groups=4,
    remat=False,
)
