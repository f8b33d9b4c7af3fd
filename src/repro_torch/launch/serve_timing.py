"""Serving time of smollm-135m through the paged engine, as
``chip_smoke.py``'s serving phase takes it: published widths, random
weights from seed 0, 8 requests with ragged prompts of 24-256 tokens drawn
from seed 0, 4 slots, 32 greedy tokens each, pages of 16.

One warm-up serve, then ``--runs`` timed ones; for each, tokens/s, the
median decode wave and prefill on the host clock (each ends in a device
sync) and the median time to first token (queue wait included).  Then the
host's cost of one prefill attention call (``ops.flash_attention`` under
``torch.no_grad`` at a 256-token prompt, as the engine makes it): the
median over ``--runs`` rounds of the wall of ``ATTN_CALLS`` calls back to
back, divided by their number, and the device time of one call.  It uses
only the engine's public interface, so the same file times an older tree
of the port: copy it into that tree's ``src/repro_torch/launch/`` and run it
with that tree's ``src`` first on ``PYTHONPATH``.

    python -m repro_torch.launch.serve_timing [--runs 3] [--label change]
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch.serve import paged_spec
from repro_torch.models import transformer as T
from repro_torch.serve import (ContinuousBatchingScheduler, Request,
                               ServeEngine, serve_requests)

SLOTS, REQUESTS, NEW_TOKENS, PAGE_SIZE = 4, 8, 32, 16
PROMPT_LENGTHS = (24, 256)
ATTN_CALLS = 300


def serve_once(cfg, params, prompts, spec) -> dict:
    engine = ServeEngine(cfg, params, kv_spec=spec, n_slots=SLOTS,
                         temperature=0.0)
    sched = ContinuousBatchingScheduler(SLOTS, spec)
    waves, prefills = [], []
    admit, step = engine.admit, engine.step

    def timed_admit(slot, prompt, pages):
        t0 = time.perf_counter()
        tok = admit(slot, prompt, pages)
        prefills.append(time.perf_counter() - t0)
        return tok

    def timed_step():
        t0 = time.perf_counter()
        toks = step()
        waves.append(time.perf_counter() - t0)
        return toks

    engine.admit, engine.step = timed_admit, timed_step
    reqs = [Request(prompt=p, max_new_tokens=NEW_TOKENS) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fin = serve_requests(engine, sched, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"tokens_per_s": sum(len(r.tokens) for r in fin) / wall,
            "wave_ms": 1e3 * statistics.median(waves),
            "prefill_ms": 1e3 * statistics.median(prefills),
            "ttft_ms": 1e3 * statistics.median(r.ttft for r in fin),
            "tokens": sorted(r.tokens for r in fin)}


def attention_call_us(cfg, runs: int) -> dict:
    """Host and device microseconds of one prefill attention call."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    s = PROMPT_LENGTHS[1]
    q = torch.randn((1, s, cfg.n_heads, cfg.hd), generator=gen,
                    device="cuda")
    k, v = (torch.randn((1, s, cfg.n_kv_heads, cfg.hd), generator=gen,
                        device="cuda") for _ in range(2))
    host, device = [], []
    with torch.no_grad():
        for _ in range(runs):
            ops.flash_attention(q, k, v)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ATTN_CALLS):
                ops.flash_attention(q, k, v)
            host.append((time.perf_counter() - t0) / ATTN_CALLS * 1e6)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            ops.flash_attention(q, k, v)
            end.record()
            end.synchronize()
            device.append(start.elapsed_time(end) * 1e3)
    return {"attention_host_us": statistics.median(host),
            "attention_event_us": statistics.median(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    cfg = configs.get_config("smollm-135m")
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    lengths = rng.integers(PROMPT_LENGTHS[0], PROMPT_LENGTHS[1] + 1,
                           REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in lengths]
    spec = paged_spec(SLOTS, PROMPT_LENGTHS[1] + NEW_TOKENS, PAGE_SIZE)
    first = serve_once(cfg, params, prompts, spec)
    for i in range(args.runs):
        got = serve_once(cfg, params, prompts, spec)
        if got["tokens"] != first["tokens"]:
            raise AssertionError("a timed serve's tokens differ from the "
                                 "warm-up's")
        print(json.dumps({"label": args.label, "run": i,
                          **{k: v for k, v in got.items() if k != "tokens"}}),
              flush=True)
    print(json.dumps({"label": args.label,
                      **attention_call_us(cfg, args.runs)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
