"""Continuous-batching scheduler: admission, eviction, refill.

Pure host-side bookkeeping, no tensors: the port's copy of the JAX
package's ``serve/scheduler.py``.  Requests queue with arrival
timestamps; :meth:`ContinuousBatchingScheduler.admit` moves them into free
decode slots as soon as the page pool can cover their worst case
(``ceil((len(prompt) + max_new_tokens) / page_size)`` pages, allocated up
front so a request never stalls mid-decode).  On EOS or the token budget
the slot is released and refilled on the next ``admit`` — the batch never
drains to run a single straggler.

``refill="static"`` is the ablation baseline: a wave of requests is
admitted only when *every* slot is free, and nothing refills until the
whole wave finishes — classic static batching, where the longest request
holds the batch hostage (the JAX package's ``benchmarks/serve.py`` races
the two modes).
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Literal, Optional

from repro_torch.serve.kv_cache import PagePool, PagedKVSpec

_RID = itertools.count()


@dataclasses.dataclass
class Request:
    """One decode request plus its lifecycle timestamps (seconds, on
    whatever clock the caller passes as ``now``)."""
    prompt: list[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival: float = 0.0
    rid: int = dataclasses.field(default_factory=lambda: next(_RID))
    # filled in by the scheduler / engine
    tokens: list[int] = dataclasses.field(default_factory=list)
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.t_done is not None

    @property
    def latency(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.arrival

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (queue wait + prefill)."""
        return None if self.t_first_token is None \
            else self.t_first_token - self.arrival


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    pages: list[int] = dataclasses.field(default_factory=list)

    @property
    def free(self) -> bool:
        return self.request is None


class ContinuousBatchingScheduler:
    """Admission/eviction over ``n_slots`` decode slots and one page pool."""

    def __init__(self, n_slots: int, spec: PagedKVSpec, *,
                 refill: Literal["continuous", "static"] = "continuous"):
        self.spec = spec
        self.pool = PagePool(spec)
        self.refill = refill
        self.slots = [_Slot() for _ in range(n_slots)]
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []

    # -- state views --------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(not s.free for s in self.slots)

    @property
    def idle(self) -> bool:
        return self.n_active == 0 and not self.queue

    def active_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if not s.free]

    # -- lifecycle ----------------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.spec.max_context:
            raise ValueError(
                f"request {req.rid}: {len(req.prompt)}+{req.max_new_tokens} "
                f"tokens exceeds max_context={self.spec.max_context}")
        self.queue.append(req)

    def admit(self, now: float) -> list[tuple[int, Request]]:
        """Admit queued requests into free slots while pages last.

        Returns ``[(slot, request), ...]`` — the engine prefills each one.
        Static refill only admits into a fully-drained batch."""
        if self.refill == "static" and self.n_active > 0:
            return []
        admitted = []
        for i, slot in enumerate(self.slots):
            if not slot.free or not self.queue:
                continue
            req = self.queue[0]
            if req.arrival > now:
                break               # FIFO in arrival order
            need = self.spec.pages_for(len(req.prompt) + req.max_new_tokens)
            if not self.pool.can_reserve(need):
                break               # FIFO: don't starve the head request
            self.queue.popleft()
            slot.request = req
            slot.pages = self.pool.alloc(need)
            req.t_admitted = now
            admitted.append((i, req))
        return admitted

    def on_token(self, slot_idx: int, token: int,
                 now: float) -> Optional[Request]:
        """Record one generated token; evict + return the request when it
        hits EOS or its token budget, else None."""
        slot = self.slots[slot_idx]
        req = slot.request
        assert req is not None, f"token for free slot {slot_idx}"
        if req.t_first_token is None:
            req.t_first_token = now
        req.tokens.append(token)
        hit_eos = req.eos_id is not None and token == req.eos_id
        if hit_eos or len(req.tokens) >= req.max_new_tokens:
            req.t_done = now
            self.pool.release(slot.pages)
            slot.request = None
            slot.pages = []
            self.finished.append(req)
            return req
        return None
