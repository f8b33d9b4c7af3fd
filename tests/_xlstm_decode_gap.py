"""How far xlstm-1.3b's greedy decode lies from its teacher-forced forward
in the port on the CPU, at all 48 layers of its published pattern (6
repeats of 7 mLSTM blocks and 1 sLSTM block) and a narrower width.  The
card serves the published widths, which this machine should not hold;
``chip_smoke.py`` runs the same check there (``launch.decode_check``).

    PYTHONPATH=src python tests/_xlstm_decode_gap.py [--d-model 128] \\
        [--layers 48] [--prompt-len 1000] [--new 16] [--float64]

Random weights from seed 0 (``init_params``), 2 prompts from seed 0, as
``chip_smoke.py`` serves them: the prefill and ``new - 1`` decode steps
(the recurrence, fed the greedy tokens), against a forward of each prompt
and its tokens (batch 1) with every mLSTM on the recurrence
(``mlstm_reference``); then the same forward with the chunked form (the
pair as served) and the decode after each fault of
``decode_check.faults`` (states zeroed after the prefill, which the gate
must see).  With ``--float64`` the same weights in float64, and each
fp32 path also against the float64 forward.  Prints each step's largest
|gap| and the largest |logit|.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch import decode_check as dc
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map


def readings(cfg, params, prompts, n_new, tokens=None):
    """The decode logits (each fault's too) and the forward on the
    recurrence, and the forward with the chunked mLSTM."""
    faults = dc.faults(cfg)
    with torch.no_grad(), dc.sequential_scans():
        if tokens is None:
            tokens = dc.decode_logits(cfg, params, prompts,
                                      n_new)[0]["served"].argmax(-1)
        runs = dc.decode_logits(cfg, params, prompts, n_new, feed=tokens,
                                faults=faults)[0]
        seq = dc.forced_logits(cfg, params, prompts, tokens)
    with torch.no_grad():
        chunked = dc.forced_logits(cfg, params, prompts, tokens)
    return tokens, runs, seq, chunked


def report(name, g) -> None:
    print(f"  {name}: max {float(g.max()):.3e}, per step "
          + ", ".join(f"{float(x):.1e}" for x in g))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--prompt-len", type=int, default=1000)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--float64", action="store_true")
    args = ap.parse_args(argv)
    full = configs.get_config("xlstm-1.3b")
    cfg = dataclasses.replace(
        full, d_model=args.d_model,
        stages=configs.patterned_stages(full.stages[0].blocks, args.layers))
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, args.prompt_len)))
    tokens, runs, seq, chunked = readings(cfg, params, prompts, args.new)
    print(f"xlstm-1.3b pattern, {args.layers} layers, d_model "
          f"{args.d_model}, 2 x {args.prompt_len} prompt tokens, {args.new} "
          f"new; max |logit| {float(runs['served'].abs().max()):.3f}")
    report("recurrence vs decode", dc.step_gaps(seq, runs["served"]))
    report("chunked vs decode", dc.step_gaps(chunked, runs["served"]))
    for f in dc.faults(cfg):
        report(f"{f} zeroed", dc.step_gaps(seq, runs[f]))
    if args.float64:
        p64 = tree_map(lambda t: t.double(), params)
        _, runs64, seq64, _ = readings(cfg, p64, prompts, args.new, tokens)
        report("float64: recurrence vs decode",
               dc.step_gaps(seq64, runs64["served"]))
        for name, t in (("fp32 recurrence forward", seq),
                        ("fp32 chunked forward", chunked),
                        ("fp32 decode", runs["served"])):
            report(f"{name} vs float64", dc.step_gaps(seq64, t))


if __name__ == "__main__":
    main()
