"""Decode engine of the port (``src/repro/serve/engine.py``): one fused
decode wave over paged KV pools for every slot.

A wave is {embed the slot tokens, paged attention decode through every
layer, sample, write the new K/V into the pages}: one ``decode_step`` over
all slots, whatever their number of live requests.  Slot liveness never
reaches the device: an inactive slot has an all ``-1`` block-table row,
its K/V write lands on the dump page and its sampled token is ignored on
the host.  The pools are written in place (the JAX engine donates them).
A MoE block dispatches the wave's slots, live or empty, as one group of
``n_slots`` tokens, as the JAX engine's wave does: empty slots take expert
capacity too.

Prefill runs ``models.transformer.forward(mode="prefill")`` once per
admitted request, right-padded to whole pages (``ceil(len/page_size)``
pages).  Causal masking keeps the pad rows out of the sampled logits; their
K/V reach the slot's last page beyond its ``seq_len``, where they stay
masked until the slot's own tokens overwrite them.  Sampling is greedy
``argmax`` at temperature 0, else a categorical draw from the engine's
``torch.Generator`` (seeded with ``seed``).

With a ``telemetry`` (``repro_torch.obs.Telemetry``), as in the JAX
package: a ``serve.prefill`` span around each admission's prefill, a
``serve.step`` span around each decode wave (up to the sampled tokens
reaching the host) and a ``serve`` event per admission.

:func:`serve_requests` is the serving loop that wires this engine to a
:class:`~repro_torch.serve.scheduler.ContinuousBatchingScheduler`.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.serve import kv_cache
from repro_torch.serve.kv_cache import PagedKVSpec
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request

Tensor = torch.Tensor


def sample_tokens(logits: Tensor, generator: torch.Generator,
                  temperature: float) -> Tensor:
    """(..., V) logits -> (...) int64 tokens: (B, V) -> (B,), and with
    codebooks (B, CB, V) -> (B, CB)."""
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        return torch.multinomial(flat, 1, generator=generator)[:, 0] \
            .reshape(probs.shape[:-1])
    return torch.argmax(logits, dim=-1)


class ServeEngine:
    """Device state (pools; block table, positions and slot tokens on the
    host) and the decode wave.  Runs on the device of ``params``."""

    def __init__(self, cfg: ModelConfig, params: dict, *,
                 kv_spec: PagedKVSpec | None = None, n_slots: int = 4,
                 temperature: float = 0.0, seed: int = 0, telemetry=None):
        kv_cache.validate_config(cfg)
        self.cfg = cfg
        self.params = params
        self.spec = kv_spec or PagedKVSpec()
        self.n_slots = n_slots
        self.temperature = float(temperature)
        self.telemetry = telemetry
        self.device = params["embed"].device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.pools = kv_cache.init_pools(cfg, self.spec, params["embed"].dtype,
                                         self.device)
        m = self.spec.max_pages_per_slot
        self._bt = np.full((n_slots, m), -1, np.int32)
        self._positions = np.zeros((n_slots,), np.int32)
        self._tokens = np.zeros((n_slots,), np.int64)
        self._active = np.zeros((n_slots,), bool)
        #: logits of the last prefill (V,) or decode wave (n_slots, V)
        self.last_logits: Tensor | None = None
        self.steps_run = 0
        self.tokens_generated = 0

    def _to_device(self, a: np.ndarray) -> Tensor:
        return torch.from_numpy(a.copy()).to(self.device)

    def _span(self, name: str):
        if self.telemetry is None:
            return contextlib.nullcontext()
        return self.telemetry.span(name)

    # -- slot lifecycle -----------------------------------------------------

    def admit(self, slot: int, prompt: list[int], pages: list[int]) -> int:
        """Prefill ``prompt`` into ``pages`` (the slot's full reservation)
        and return the first sampled token."""
        ps = self.spec.page_size
        length = len(prompt)
        assert 0 < length and not self._active[slot], (slot, length)
        npg = self.spec.pages_for(length)
        assert len(pages) >= npg, (len(pages), npg)
        cache_len = npg * ps

        tokens = np.zeros((1, cache_len), np.int64)
        tokens[0, :length] = prompt
        with self._span("serve.prefill"):
            logits, _, caches = transformer.forward(
                self.params, self.cfg, self._to_device(tokens),
                mode="prefill", cache_len=cache_len)
            self.last_logits = logits[0, length - 1]
            first = int(sample_tokens(self.last_logits[None], self.generator,
                                      self.temperature)[0])
            kv_cache.scatter_prompt(
                self.pools, caches, self._to_device(np.asarray(pages[:npg])),
                cfg=self.cfg, page_size=ps)

        self._bt[slot] = -1
        self._bt[slot, :len(pages)] = pages
        self._positions[slot] = length
        self._tokens[slot] = first
        self._active[slot] = True
        self.tokens_generated += 1
        if self.telemetry is not None:
            self.telemetry.event("serve", {
                "kind": "admit", "slot": slot, "prompt_len": length,
                "pages": len(pages)})
        return first

    def release(self, slot: int) -> None:
        self._bt[slot] = -1
        self._positions[slot] = 0
        self._tokens[slot] = 0
        self._active[slot] = False

    # -- the decode wave ----------------------------------------------------

    def step(self) -> np.ndarray:
        """One fused decode step for every slot; returns the (n_slots,)
        sampled tokens (garbage at inactive slots: callers consult the
        scheduler for liveness)."""
        with self._span("serve.step"):
            logits, self.pools = transformer.decode_step(
                self.params, self.cfg, self._to_device(self._tokens),
                (self._to_device(self._positions), self._to_device(self._bt)),
                self.pools)
            self.last_logits = logits
            nxt = sample_tokens(logits, self.generator, self.temperature)
            nxt = nxt.cpu().numpy()
        act = self._active
        self._tokens[act] = nxt[act]
        self._positions[act] += 1
        self.steps_run += 1
        self.tokens_generated += int(act.sum())
        return nxt


def serve_requests(engine: ServeEngine,
                   sched: ContinuousBatchingScheduler,
                   requests: list[Request], *,
                   clock=None, idle_sleep: float = 1e-4) -> list[Request]:
    """Drive the engine until every request finishes.

    ``clock`` defaults to ``time.monotonic``; request ``arrival`` fields are
    offsets from the loop's start on that clock."""
    clock = clock or time.monotonic
    t0 = clock()

    def now():
        return clock() - t0

    for r in sorted(requests, key=lambda r: r.arrival):
        sched.submit(r)

    while not sched.idle:
        for slot, req in sched.admit(now()):
            first = engine.admit(slot, req.prompt, sched.slots[slot].pages)
            if sched.on_token(slot, first, now()) is not None:
                engine.release(slot)
        if sched.n_active == 0:
            time.sleep(idle_sleep)      # waiting on future arrivals
            continue
        toks = engine.step()
        t = now()
        for slot in sched.active_slots():
            if sched.on_token(slot, int(toks[slot]), t) is not None:
                engine.release(slot)
    return sched.finished
