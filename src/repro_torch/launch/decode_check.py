"""A greedy decode held against its teacher-forced forward.

The prefill of a batch of prompts, then decode steps (the serve step of
``launch.steps``, caches written in place) fed the greedy tokens or given
ones, each step's logits against a forward of each prompt and those
tokens.  ``chip_smoke.py`` runs it on every configuration served with
contiguous caches; ``tests/_xlstm_decode_gap.py`` runs it on the CPU.

With recurrent blocks (Mamba2, mLSTM, sLSTM), :class:`sequential_scans`
makes the prefill and the forward run the recurrences a decode step runs
(the sequential SSD, the mLSTM recurrence) in place of the chunked forms,
and :func:`zero_states` zeroes part of the caches after the prefill (the
faults of :data:`FAULTS`): a decode that lost that state, which the
comparison must see.
"""
from __future__ import annotations

import time

import torch

from repro_torch.launch import synchronize
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map

__all__ = ["RECURRENT", "FAULTS", "has_recurrent", "sequential_scans",
           "faults", "zero_states", "decode_logits", "forced_logits",
           "step_gaps"]

#: the block kinds whose decode carries a recurrent state, and the cache
#: entries that hold it
RECURRENT = {"mamba": ("ssm", "conv"), "mlstm": ("C", "n", "m", "conv"),
             "slstm": ("state",)}
#: the states each fault zeroes after the prefill: every recurrent state;
#: the conv windows (Mamba2, mLSTM); the sLSTM state tuples; every state
#: of the last repeat of each stacked stage
FAULTS = ("every state", "conv states", "sLSTM states", "last repeat")


def has_recurrent(cfg) -> bool:
    return any(sp.kind in RECURRENT for st in cfg.stages for sp in st.blocks)


class sequential_scans:
    """While open, the prefill and the forward run the recurrences a
    decode step runs in place of the chunked forms: the Mamba2 block the
    sequential SSD (``ssm.ssd_reference``), the mLSTM its recurrence
    (``xlstm.mlstm_reference``)."""

    def __enter__(self):
        from repro_torch.models import ssm, xlstm
        self.saved = ssm._ssd_chunked, xlstm._mlstm_chunked
        ssm._ssd_chunked = lambda x, b_, c_, dt, la, chunk: \
            ssm.ssd_reference(x, b_, c_, dt, la)
        xlstm._mlstm_chunked = lambda q, k, v, li, lf, chunk: \
            xlstm.mlstm_reference(q, k, v, li, lf)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import ssm, xlstm
        ssm._ssd_chunked, xlstm._mlstm_chunked = self.saved


def _targets(cfg, fault: str):
    """(stage, block, cache key, stacked) of every state ``fault`` zeroes."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    for i, st in enumerate(cfg.stages):
        if fault == "last repeat" and st.repeat == 1:
            continue
        for j, sp in enumerate(st.blocks):
            for key in RECURRENT.get(sp.kind, ()):
                if (fault == "conv states" and key != "conv") or (
                        fault == "sLSTM states" and sp.kind != "slstm"):
                    continue
                yield f"s{i}", f"b{j}", key, st.repeat > 1


def faults(cfg) -> tuple[str, ...]:
    """The faults of :data:`FAULTS` that zero some state of ``cfg``."""
    return tuple(f for f in FAULTS if any(True for _ in _targets(cfg, f)))


def zero_states(caches: dict, cfg, fault: str = "every state") -> None:
    """Zero, in place, the recurrent states of ``caches`` (as the prefill
    makes them, stacked per stage) that ``fault`` names."""
    for s, b, key, stacked in _targets(cfg, fault):
        value = caches[s][b][key]
        for t in value if isinstance(value, tuple) else (value,):
            (t[-1] if fault == "last repeat" and stacked else t).zero_()


def decode_logits(cfg, params, prompts: torch.Tensor, n_new: int, *,
                  feed: torch.Tensor | None = None, faults: tuple = (),
                  frontend_embeds: torch.Tensor | None = None):
    """The prefill of ``prompts`` (B, S) ((B, S, CB) with codebooks), then
    ``n_new - 1`` decode steps, each fed the argmax or, given,
    ``feed[:, i]``.  Each fault of ``faults`` runs the same steps from a
    copy of the prefill's caches with :func:`zero_states` applied (one
    prefill for all).  Returns ({"served" or fault: (B, n_new, [CB,] V)
    logits on the CPU, in the model's dtype}, the prefill's wall (TTFT)
    and each served step's wall, in seconds, the device synchronized)."""
    dev = prompts.device
    batch, prompt_len = prompts.shape[:2]
    serve_step = make_serve_step(cfg)
    synchronize(dev)
    t0 = time.perf_counter()
    logits, _, caches = T.forward(params, cfg, prompts,
                                  frontend_embeds=frontend_embeds,
                                  mode="prefill",
                                  cache_len=prompt_len + n_new,
                                  last_logits_only=True)
    first = logits[:, -1]
    synchronize(dev)
    ttft = time.perf_counter() - t0
    outs, steps = {}, []
    # the faults first, each from its own copy, then the served steps,
    # which write the prefill's caches themselves
    for name in (*faults, "served"):
        if name == "served":
            run = caches
        else:
            run = tree_map(torch.clone, caches)
            zero_states(run, cfg, name)
        rows, tok = [first.cpu()], first.argmax(-1)
        for i in range(n_new - 1):
            t1 = time.perf_counter()
            pos = torch.full((batch,), prompt_len + i, dtype=torch.int32,
                             device=dev)
            lg, run = serve_step(params, tok if feed is None else feed[:, i],
                                 pos, run, frontend_embeds=frontend_embeds)
            tok = lg.argmax(-1)
            rows.append(lg.cpu())
            if name == "served":
                steps.append(time.perf_counter() - t1)
        outs[name] = torch.stack(rows, dim=1)
        del run
    return outs, ttft, steps


def forced_logits(cfg, params, prompts: torch.Tensor, tokens: torch.Tensor,
                  frontend_embeds: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Teacher-forced logits (B, n_new, [CB,] V) on the CPU: a forward of
    each prompt and its ``tokens`` but the last (batch 1), the rows from
    the prompt's last position on."""
    prompt_len = prompts.shape[1]
    rows = []
    for b in range(prompts.shape[0]):
        seq = torch.cat([prompts[b], tokens[b, :-1]])[None]
        full, _, _ = T.forward(
            params, cfg, seq, frontend_embeds=None if frontend_embeds is None
            else frontend_embeds[b:b + 1])
        rows.append(full[0, prompt_len - 1:].cpu())
        del full
    return torch.stack(rows)


def step_gaps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each decode step's largest |a - b| over the batch: a, b (B, steps,
    ...)."""
    return (a - b).abs().transpose(0, 1).flatten(1).amax(1)
