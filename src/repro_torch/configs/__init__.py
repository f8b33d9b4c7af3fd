"""Config registry of the port: the JAX package's architecture ids, of
which the ported ones resolve to their ``ModelConfig``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (AttnSpec, BlockSpec, FrontendSpec,
                                      ModelConfig, MoESpec, SSMSpec, Stage,
                                      patterned_stages, uniform_stages)

__all__ = ["ARCH_IDS", "AttnSpec", "BlockSpec", "FrontendSpec",
           "ModelConfig", "MoESpec", "SSMSpec", "Stage", "get_config",
           "patterned_stages", "uniform_stages"]

_PORTED = {
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
}

#: every architecture of the JAX package's registry, in its order
ARCH_IDS = ("deepseek-v2-236b", "gemma3-27b", "granite-3-2b", "granite-3-8b",
            "zamba2-2.7b", "llama-3.2-vision-11b", "smollm-135m",
            "musicgen-large", "granite-moe-1b-a400m", "xlstm-1.3b")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    """``SMOKE`` or ``CONFIG`` of ``arch``; raises for an architecture the
    port does not run yet, and for an unknown one."""
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; known: {ARCH_IDS}")
    if arch not in _PORTED:
        raise NotImplementedError(f"architecture {arch!r} is not ported yet; "
                                  f"ported: {sorted(_PORTED)}")
    mod = importlib.import_module(_PORTED[arch])
    return mod.SMOKE if smoke else mod.CONFIG
