"""Entry points of the port."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; asking for CUDA without a card raises
    (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def frontend_embeds(cfg, lead: tuple, seed: int, device):
    """Stubbed frontend embeddings (*lead, n_tokens, embed_dim) of
    ``cfg.frontend``, 0.1 * N(0, 1) from a CPU ``torch.Generator`` seeded
    with ``seed`` (the same on every device), on ``device``; None without
    a frontend.  The JAX launchers draw theirs with ``jax.random``; the
    train CLI seeds its key with ``hash((seed, "fe"))``, which Python
    salts per process for strings, so its draw is not reproducible and is
    not copied."""
    if cfg.frontend is None:
        return None
    gen = torch.Generator().manual_seed(seed)
    shape = (*lead, cfg.frontend.n_tokens, cfg.frontend.embed_dim)
    return (0.1 * torch.randn(shape, generator=gen)).to(device)
