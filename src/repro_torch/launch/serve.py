"""Serving launcher of the port (``src/repro/launch/serve.py``): batched
autoregressive decode of a transformer (dense, MoE, MLA, codebooks,
cross-attention onto a stubbed vision frontend, or Mamba2 blocks beside
attention), by default smollm-135m,
at its published widths with random weights from ``--seed``.

    python -m repro_torch.launch.serve                  # paged engine, card
    python -m repro_torch.launch.serve --legacy         # contiguous caches
    python -m repro_torch.launch.serve --device cpu --smoke
    python -m repro_torch.launch.serve --arch granite-moe-1b-a400m
    python -m repro_torch.launch.serve --arch gemma3-27b
    python -m repro_torch.launch.serve --arch deepseek-v2-236b --smoke
    python -m repro_torch.launch.serve --arch zamba2-2.7b --smoke

``--arch`` takes smollm-135m, granite-3-2b, granite-3-8b and
granite-moe-1b-a400m (paged, or contiguous with ``--legacy``), and
gemma3-27b (sliding windows), musicgen-large (4 codebooks; its prompts
are (B, S, 4) and its tokens (B, n_new, 4)), deepseek-v2-236b (MLA, MoE)
and llama-3.2-vision-11b (cross-attention; each prompt comes with
n_tokens x embed_dim frontend embeddings, 0.1 * N(0, 1) from ``--seed``)
and zamba2-2.7b (Mamba2 blocks, whose decode carries a fixed-size state
``{ssm, conv}`` in place of a KV cache, and 9 attention blocks at head dim
80), which the paged engine refuses and which take the contiguous path;
prompts are (B, S), of equal length, as ``generate`` takes them.  The
path is picked by architecture, as the JAX launcher picks it: paged where
the engine takes the configuration (``serve.kv_cache.refusal`` is None,
the check behind the engine's ``validate_config``), else contiguous
(:func:`generate`); the JAX launcher tries the engine and catches its
``ValueError``, the port asks first.  Runs on the card unless
``--device cpu``; TF32 is off (the models are fp32).  At their published
widths deepseek-v2-236b's 60 layers and gemma3-27b's 62 do not fit one
card.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import configs
from repro_torch.launch import frontend_embeds, resolve_device, synchronize
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer as T
from repro_torch.serve import (ContinuousBatchingScheduler, PagedKVSpec,
                               Request, ServeEngine, serve_requests)
from repro_torch.serve import kv_cache
from repro_torch.serve.engine import sample_tokens


def generate(cfg, params, prompt_tokens: torch.Tensor, n_new: int, *,
             frontend_embeds: torch.Tensor | None = None,
             temperature: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Contiguous-cache decode: prefill (B, S) prompts ((B, S, CB) with
    codebooks), then ``n_new - 1`` decode steps; returns the (B, n_new)
    ((B, n_new, CB)) sampled tokens, greedy at temperature 0, else drawn
    from a generator seeded with ``seed``.  ``frontend_embeds`` (B,
    n_tokens, embed_dim) feed every cross-attention layer, in the prefill
    and in every decode step."""
    b, s = prompt_tokens.shape[:2]
    dev = prompt_tokens.device
    logits, _, caches = T.forward(params, cfg, prompt_tokens,
                                  frontend_embeds=frontend_embeds,
                                  mode="prefill", cache_len=s + n_new,
                                  last_logits_only=True)
    serve_step = make_serve_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = sample_tokens(logits[:, -1], gen, temperature)
    out = [tok]
    for i in range(n_new - 1):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=dev)
        lg, caches = serve_step(params, tok, pos, caches,
                                frontend_embeds=frontend_embeds)
        tok = sample_tokens(lg, gen, temperature)
        out.append(tok)
    return torch.stack(out, dim=1)


def paged_spec(batch: int, context: int, page_size: int) -> PagedKVSpec:
    """The launcher's pool: room for twice ``batch`` slots of ``context``
    tokens, plus the dump page."""
    per_slot = -(-context // page_size)
    return PagedKVSpec(page_size=page_size, n_pages=batch * per_slot * 2 + 1,
                       max_pages_per_slot=per_slot)


def _prompts(cfg, args, dev) -> torch.Tensor:
    gen = torch.Generator().manual_seed(args.seed + 1)
    shape = (args.batch, args.prompt_len) + (
        (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ())
    return torch.randint(0, cfg.vocab_size, shape, generator=gen).to(dev)


def _serve_engine(cfg, params, args, dev) -> dict:
    """The paged decode service: continuous batching over a fixed-slot
    batch with block-table paged KV pools."""
    spec = paged_spec(args.batch, args.prompt_len + args.new_tokens,
                      args.page_size)
    engine = ServeEngine(cfg, params, kv_spec=spec, n_slots=args.batch,
                         temperature=args.temperature, seed=args.seed)
    sched = ContinuousBatchingScheduler(args.batch, spec)
    reqs = [Request(prompt=p.tolist(), max_new_tokens=args.new_tokens)
            for p in _prompts(cfg, args, dev)]
    synchronize(dev)
    t0 = time.perf_counter()
    fin = serve_requests(engine, sched, reqs)
    synchronize(dev)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in fin)
    return {"arch": cfg.name, "mode": "paged", "device": str(dev),
            "batch": args.batch, "new_tokens": args.new_tokens,
            "wall_s": dt, "tok_per_s": n_tok / dt,
            "decode_waves": engine.steps_run, "sample": fin[0].tokens[:8]}


def _serve_legacy(cfg, params, args, dev) -> dict:
    """Contiguous-cache batched decode (:func:`generate`)."""
    prompt = _prompts(cfg, args, dev)
    fe = frontend_embeds(cfg, (args.batch,), args.seed, dev)
    synchronize(dev)
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompt, args.new_tokens,
                    frontend_embeds=fe, temperature=args.temperature,
                    seed=args.seed)
    synchronize(dev)
    dt = time.perf_counter() - t0
    return {"arch": cfg.name, "mode": "legacy", "device": str(dev),
            "batch": args.batch, "new_tokens": args.new_tokens,
            "wall_s": dt, "tok_per_s": args.batch * args.new_tokens / dt,
            "sample": toks[0].tolist()[:8]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m", choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="the architecture's reduced SMOKE config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--legacy", action="store_true",
                    help="the contiguous-cache decode path (taken anyway "
                         "where the paged engine refuses the "
                         "architecture)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config(args.arch, smoke=args.smoke)
    params = T.init_params(torch.Generator(device=dev).manual_seed(args.seed),
                           cfg)
    paged = not args.legacy and kv_cache.refusal(cfg) is None
    run = _serve_engine if paged else _serve_legacy
    print(json.dumps(run(cfg, params, args, dev)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
