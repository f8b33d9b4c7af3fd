"""Step functions of the port (``src/repro/launch/steps.py``): the serving
steps.  The LM trainer (``build_trainer``) waits for the training slice."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def make_serve_step(cfg: ModelConfig):
    """One-token decode against per-layer caches (written in place):
    ``serve_step(params, token, position, cache) -> (logits, cache)``."""
    def serve_step(params, token, position, cache):
        return T.decode_step(params, cfg, token, position, cache)
    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """Full-sequence prefill: ``prefill_step(params, tokens) ->
    (final-position logits, caches)``."""
    def prefill_step(params, tokens):
        logits, _, caches = T.forward(params, cfg, tokens, mode="prefill",
                                      last_logits_only=True)
        return logits[:, -1], caches
    return prefill_step
