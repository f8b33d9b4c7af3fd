"""Decentralized LM training: group-DRO language models (by default
smollm-135m) under DRSGDA (or DRGDA, or a baseline) on a ring of nodes
stacked on one card.

The port's counterpart of ``src/repro/launch/train.py`` (its ``host``
regime; the TPU meshes of ``--device-grid`` have none), with every flag of
the JAX CLI and its defaults, plus ``--device`` (default ``cuda``; the
tests pass ``cpu``).  ``--arch`` takes every ported architecture:
smollm-135m, granite-3-2b, granite-3-8b, gemma3-27b, musicgen-large (4
codebook streams), granite-moe-1b-a400m and deepseek-v2-236b (MoE),
llama-3.2-vision-11b (cross-attention onto a stubbed vision frontend)
and zamba2-2.7b (Mamba2 blocks beside attention; its Mamba2 leaves are
Euclidean, its attention's wq, wk, wv and wo on the Stiefel manifold).
TF32 is off for matmuls and cuDNN: the reference is fp32.  Initial weights
are drawn with a ``torch.Generator`` seeded with ``--seed`` on the device
(the JAX CLI draws with ``jax.random``, which the port cannot reproduce);
the token stream is the JAX package's, byte for byte.  A model with a
frontend gets one set of node-stacked embeddings (nodes, batch per node,
n_tokens, embed_dim), drawn once from ``--seed``
(``launch.frontend_embeds``) and fed with every batch, as the JAX CLI
feeds the same draw to every batch; the JAX CLI seeds its draw with
``hash((seed, "fe"))``, which Python salts per process for strings, so
its embeddings differ from run to run and are not copied.  Success, as
in the JAX CLI: a finite loss and a Stiefel residual under 1e-2 at the
last evaluation.

    python -m repro_torch.launch.train --arch smollm-135m --steps 20
    python -m repro_torch.launch.train --device cpu --smoke --steps 6 \
        --nodes 2 --telemetry --checkpoint-dir /tmp/ckpt --checkpoint-every 3
    python -m repro_torch.launch.train --arch llama-3.2-vision-11b --smoke
    python -m repro_torch.launch.train --arch zamba2-2.7b --smoke
    python -m repro_torch.launch.train --reference [--device cpu]
    python -m repro_torch.launch.train --reference \
        --reference-arch granite-moe-1b-a400m

``--reference`` instead runs one of the JAX package's recorded runs and
holds every point against it: smollm-135m's
(``tests/data/lm_reference.json``, written by ``tests/_reference_curves.py
lm``: full-width smollm-135m cut in depth, from
``convert.lm_params_from_seed``), or with ``--reference-arch`` one of
``tests/data/lm_models_reference.json`` (``tests/_reference_curves.py
lm_models``: granite-moe-1b-a400m and musicgen-large at their published
widths cut to 2 layers, deepseek-v2-236b, llama-3.2-vision-11b and
zamba2-2.7b at ``SMOKE``, the frontend's embeddings from
``convert.lm_frontend_from_seed``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import checkpoint, configs
from repro_torch.configs.base import patterned_stages, uniform_stages
from repro_torch.convert import (lm_batch_to_torch, lm_frontend_from_seed,
                                 lm_params_from_seed,
                                 transformer_params_from_reference)
from repro_torch.core.gda import GDAHyper
from repro_torch.core.metric import convergence_metric
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch import frontend_embeds, resolve_device, synchronize
from repro_torch.launch.steps import TrainSpec, build_trainer, init_train_state
from repro_torch.obs import Telemetry

REFERENCE = (Path(__file__).resolve().parents[3] / "tests" / "data"
             / "lm_reference.json")
#: the recorded runs of the other architectures, one per ``runs`` entry
MODELS_REFERENCE = REFERENCE.with_name("lm_models_reference.json")
#: the per-step metrics and the evaluations' quantities of a reference run
STEP_KEYS = ("loss", "grad_norm_x", "consensus_x")
EVAL_KEYS = ("M_t", "stiefel_residual")


def _span(telemetry, name, **tags):
    if telemetry is None:
        return contextlib.nullcontext()
    return telemetry.span(name, **tags)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m", choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--optimizer", default="drsgda",
                    choices=["drgda", "drsgda", "gt-gda", "gnsd-a", "dm-hsgd"])
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-per-node", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--beta", type=float, default=0.02)
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--topology", default="ring",
                    choices=["ring", "full", "torus", "star"])
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-json", default="")
    ap.add_argument("--telemetry", action="store_true",
                    help="thread wire counters through the step and stream "
                         "the convergence dashboard to an event log")
    ap.add_argument("--telemetry-dir", default="experiments/telemetry")
    ap.add_argument("--telemetry-run", default="",
                    help="run name for the event log / trace files "
                         "(default: <optimizer>-<arch>)")
    ap.add_argument("--churn", default="static",
                    choices=["static", "random"],
                    help="elastic-gossip churn schedule (random: seeded "
                         "per-round leave/rejoin Markov draws)")
    ap.add_argument("--churn-leave-rate", type=float, default=0.05)
    ap.add_argument("--churn-join-rate", type=float, default=0.5)
    ap.add_argument("--tau", type=int, default=0,
                    help="elastic stale-hop tolerance (rounds)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reference", action="store_true",
                    help="run the JAX package's recorded run and hold it "
                         "against its gates (the other flags but --device "
                         "and --reference-arch are ignored)")
    ap.add_argument("--reference-arch", default="smollm-135m",
                    help="with --reference: smollm-135m "
                         "(lm_reference.json) or a run of "
                         "lm_models_reference.json")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.reference:
        ref = load_reference(args.reference_arch)
        res = run_reference(ref, dev)
        comparison = compare_to_reference(res, ref)
        ok = within_reference(comparison)
        print(json.dumps({**res, "comparison": comparison,
                          "within_reference": ok}), flush=True)
        return 0 if ok else 1

    telemetry = None
    if args.telemetry:
        telemetry = Telemetry(
            run=args.telemetry_run or f"{args.optimizer}-{args.arch}",
            out_dir=args.telemetry_dir, flush_every=args.eval_every)

    cfg = configs.get_config(args.arch, smoke=args.smoke)
    hyper = GDAHyper(alpha=args.alpha, beta=args.beta, eta=args.eta)
    elastic = None
    if args.churn != "static" or args.tau > 0:
        from repro_torch.comms.elastic import ChurnSchedule, ElasticSpec
        elastic = ElasticSpec(
            churn=ChurnSchedule(kind=args.churn,
                                leave_rate=args.churn_leave_rate,
                                join_rate=args.churn_join_rate),
            tau=args.tau, seed=args.seed)
    spec = TrainSpec(optimizer=args.optimizer, topology=args.topology,
                     elastic=elastic, telemetry=telemetry, hyper=hyper)
    opt, problem = build_trainer(cfg, args.nodes, spec)

    stream = TokenStream(n_nodes=args.nodes, batch_per_node=args.batch_per_node,
                         seq_len=args.seq_len, vocab_size=cfg.vocab_size,
                         n_groups=cfg.n_groups, n_codebooks=cfg.n_codebooks,
                         seed=args.seed)
    fe = frontend_embeds(cfg, (args.nodes, args.batch_per_node), args.seed,
                         dev)

    def to_torch(b):
        out = lm_batch_to_torch(b, dev)
        if fe is not None:
            out["frontend_embeds"] = fe
        return out

    batch0 = to_torch(stream.batch(0))
    with _span(telemetry, "init"):
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        state = init_train_state(gen, cfg, opt, args.nodes, batch0)

    history = []
    t_start = time.time()
    with _span(telemetry, "train", steps=args.steps):
        for t in range(args.steps):
            batch = to_torch(stream.batch(t + 1))
            state, metrics = opt.step(state, batch)
            if (t + 1) % args.eval_every == 0 or t == args.steps - 1:
                with _span(telemetry, "eval", step=t + 1):
                    m = convergence_metric(problem, state.x, state.y, batch)
                row = {
                    "step": t + 1,
                    "loss": float(metrics.loss),
                    "grad_norm_x": float(metrics.grad_norm_x),
                    "consensus_x": float(metrics.consensus_x),
                    "M_t": float(m["M_t"]),
                    "stiefel_residual": float(m["stiefel_residual"]),
                    "wall_s": round(time.time() - t_start, 1),
                }
                history.append(row)
                print(json.dumps(row), flush=True)
                if telemetry is not None:
                    telemetry.dashboard(problem, state.x, state.y, batch,
                                        step=t + 1,
                                        extra={"loss": row["loss"]})
                    mem = getattr(state.comm, "elastic", None)
                    if mem is not None:
                        act = mem.active.cpu().numpy()
                        prev = mem.prev_active.cpu().numpy()
                        telemetry.event("membership", {
                            "live": int(act.sum()),
                            "joins": int(((act > 0) & (prev == 0)).sum()),
                            "leaves": int(((act == 0) & (prev > 0)).sum()),
                            "active": act.astype(int).tolist(),
                        }, step=t + 1)
            if args.checkpoint_every and (t + 1) % args.checkpoint_every == 0 \
                    and args.checkpoint_dir:
                with _span(telemetry, "checkpoint", step=t + 1):
                    checkpoint.save(args.checkpoint_dir, t + 1, state.x)

    if telemetry is not None:
        paths = telemetry.export()
        print(json.dumps({"telemetry": paths}), flush=True)
    if args.log_json:
        with open(args.log_json, "w") as f:
            json.dump(history, f, indent=1)
    # success = finite loss and preserved feasibility
    ok = np.isfinite(history[-1]["loss"]) and \
        history[-1]["stiefel_residual"] < 1e-2
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# the JAX package's recorded run
# ---------------------------------------------------------------------------


def load_reference(arch: str = "smollm-135m") -> dict:
    """A recorded JAX run: smollm-135m's (``tests/_reference_curves.py
    lm``) or another architecture's (``... lm_models``)."""
    if arch == "smollm-135m":
        return json.loads(REFERENCE.read_text())
    runs = json.loads(MODELS_REFERENCE.read_text())["runs"]
    if arch not in runs:
        raise ValueError(f"no recorded run of {arch!r}; recorded: "
                         f"{sorted(runs)}")
    return runs[arch]


def reference_config(settings: dict):
    """The recorded run's model: ``settings["arch"]``'s ``SMOKE`` config
    where ``settings["smoke"]``, else its published widths cut to
    ``settings["n_layers"]`` blocks that take the distinct blocks of its
    published pattern in turn, in their order (a uniform configuration:
    one stacked stage of its block; zamba2-2.7b: a Mamba2 block, then
    attention)."""
    if settings.get("smoke"):
        return configs.get_config(settings["arch"], smoke=True)
    cfg = configs.get_config(settings["arch"])
    n = settings["n_layers"]
    kinds = list(dict.fromkeys(cfg.flat_blocks()))
    stages = uniform_stages(kinds[0], n) if len(kinds) == 1 \
        else patterned_stages(kinds, n)
    return dataclasses.replace(cfg, stages=stages, name=f"{cfg.name}-{n}L")


def reference_batch(settings: dict, cfg, stream, t: int, device) -> dict:
    """Batch ``t`` of a recorded run as the port takes it: the stream's
    tokens and group ids, and for a model with a frontend the embeddings
    of ``convert.lm_frontend_from_seed`` (the same for every batch)."""
    b = dict(stream.batch(t))
    if cfg.frontend is not None:
        b["frontend_embeds"] = lm_frontend_from_seed(
            cfg, settings["n_nodes"], settings["batch_per_node"],
            settings["frontend_seed"])
    return lm_batch_to_torch(b, device)


def run_reference(reference: dict, device="cuda", observe=None) -> dict:
    """The recorded run on ``device``: the same config, weights
    (``lm_params_from_seed``), token stream, optimizer and hyper; per step
    the step's metrics, at every evaluation step M_t and the Stiefel
    residual on the step's batch, as the JAX CLI takes them; and the
    median synchronized step time.  ``observe(problem, t, state)``, if
    given, is called after the initial projection (t = 0) and after every
    step, outside the timed span."""
    s = reference["settings"]
    dev = resolve_device(device)
    cfg = reference_config(s)
    opt, problem = build_trainer(cfg, s["n_nodes"], TrainSpec(
        optimizer=s["optimizer"], topology=s["topology"],
        hyper=GDAHyper(**s["hyper"])))
    stream = TokenStream(n_nodes=s["n_nodes"],
                         batch_per_node=s["batch_per_node"],
                         seq_len=s["seq_len"], vocab_size=cfg.vocab_size,
                         n_groups=cfg.n_groups, n_codebooks=cfg.n_codebooks,
                         seed=s["stream_seed"])
    params = transformer_params_from_reference(
        lm_params_from_seed(cfg, s["params_seed"]), dev)
    state = init_train_state(None, cfg, opt, s["n_nodes"],
                             reference_batch(s, cfg, stream, 0, dev),
                             params=params)
    if observe is not None:
        observe(problem, 0, state)
    steps, evals, step_s = [], [], []
    for t in range(s["steps"]):
        batch = reference_batch(s, cfg, stream, t + 1, dev)
        synchronize(dev)
        t0 = time.perf_counter()
        state, metrics = opt.step(state, batch)
        synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        if observe is not None:
            observe(problem, t + 1, state)
        steps.append({"step": t + 1, **{k: float(getattr(metrics, k))
                                        for k in STEP_KEYS}})
        if t + 1 in s["eval_steps"]:
            m = convergence_metric(problem, state.x, state.y, batch)
            evals.append({"step": t + 1,
                          **{k: float(m[k]) for k in EVAL_KEYS}})
    return {"steps": steps, "evals": evals, "device": str(dev),
            "us_per_step": float(np.median(step_s[1:] or step_s)) * 1e6}


def _gap(got: float, want: float, key: str) -> float:
    """Relative to the reference's value; absolute for the Stiefel
    residual (rounding noise that two implementations do not share)."""
    if key == "stiefel_residual":
        return abs(got - want)
    return abs(got - want) / max(abs(want), 1e-30)


def compare_to_reference(result: dict, reference: dict) -> dict:
    """Per curve (``steps``, ``evals``) and quantity: the largest gap over
    the gated points (``gated``), over the others (``reported``), and every
    gated point over its gate (``over``: step, gap, gate)."""
    out = {}
    for curve, keys in (("steps", STEP_KEYS), ("evals", EVAL_KEYS)):
        got, want = result[curve], reference[curve]
        if [p["step"] for p in got] != [p["step"] for p in want]:
            raise ValueError(f"{curve}: the steps differ from the reference")
        out[curve] = {}
        for key in keys:
            gates = reference["tolerance"][curve][key]
            points = [(b["step"], _gap(a[key], b[key], key), gate)
                      for a, b, gate in zip(got, want, gates)]
            gated = [p for p in points if p[2] is not None]
            rest = [p[1] for p in points if p[2] is None]
            out[curve][key] = {
                "gated": max(p[1] for p in gated) if gated else None,
                "reported": max(rest) if rest else None,
                "over": [p for p in gated if p[1] > p[2]]}
    return out


def within_reference(comparison: dict) -> bool:
    return not any(q["over"] for curve in comparison.values()
                   for q in curve.values())


if __name__ == "__main__":
    raise SystemExit(main())
