"""Orthonormal fair classification (paper Figs. 1-2) with DRGDA / DRSGDA.

The port's counterpart of ``run_method`` in
``benchmarks/fair_classification.py``: a ring of nodes, the synthetic
classification stream, the CNN with Stiefel ``fc1``/``head``, and M_t every
``eval_every`` steps.  The baselines are not ported yet.  ``comm`` (a
:class:`~repro_torch.comms.spec.CommSpec`) turns on compressed gossip and a
faulty channel; :data:`COMM_PRESETS` are the three variants of the JAX
package's ``benchmarks/comms.py`` ``fair_runs``.

    python -m repro_torch.launch.fair --method drgda --steps 30 --image-hw 28
    python -m repro_torch.launch.fair --comm int8_ef --image-hw 28
    python -m repro_torch.launch.fair --compressor int8 --gamma 0.95 \
        --quant-hops all --k-steps theorem1 --steps 5 --image-hw 28

run on the card; ``--device cpu`` runs the plain PyTorch versions of the
kernels instead.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time

import torch

from repro_torch.comms.spec import CommSpec
from repro_torch.convert import batch_to_torch
from repro_torch.core.gda import OPTIMIZERS, GDAHyper, broadcast_to_nodes
from repro_torch.core.gossip import GossipSpec
from repro_torch.core.metric import convergence_metric
from repro_torch.data.synthetic import ClassificationStream
from repro_torch.launch import resolve_device, synchronize
from repro_torch.objectives import fair

RHO = 1.0
BATCH_PER_NODE = 32
FULL_BATCHES = 4
#: the variants of ``fair_runs`` in the JAX package's benchmarks/comms.py
COMM_PRESETS = {
    "full": None,
    "int8_ef": CommSpec(compressor="int8", gamma=0.95),
    "int8_ef_drop5": CommSpec(compressor="int8", gamma=0.95, drop_rate=0.05),
}


@dataclasses.dataclass
class Run:
    """Everything one training run needs, ready for its first step."""
    opt: object
    problem: object
    stream: ClassificationStream
    full: dict            # every node's full local dataset, on the device
    state: object         # the optimizer state after ``opt.init``
    device: torch.device


def prepare(name: str, deterministic: bool, seed: int = 0,
            hyper: GDAHyper | None = None, image_hw: int = 14,
            n_nodes: int = 20, k_steps: int | None = 1,
            retraction: str = "polar_fused", device="cuda",
            comm: CommSpec | None = None, draws=None) -> Run:
    """Build the stream, the CNN, the problem and optimizer ``name``
    ("drgda" or "drsgda"), and initialize its state.

    ``k_steps=None`` takes the Theorem-1 gossip steps of the ring.  ``comm``
    routes every mix through the comms engine, with ``draws`` as its draw
    source (default: one seeded with ``comm.seed``).
    ``retraction`` sets the default hyper-parameters' retraction; a given
    ``hyper`` keeps its own.  Sets ``torch.backends.cuda.matmul.allow_tf32``
    and ``torch.backends.cudnn.allow_tf32`` to False: the system is fp32
    throughout, and TF32 convolutions alone would break trajectory parity
    with the JAX package.
    """
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown method {name!r}; ported: "
                         f"{sorted(OPTIMIZERS)}")
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    stream = ClassificationStream(n_nodes=n_nodes,
                                  batch_per_node=BATCH_PER_NODE,
                                  image_hw=image_hw, seed=seed)
    params = fair.init_cnn(torch.Generator().manual_seed(seed),
                           image_hw=image_hw, device=dev)
    problem = fair.make_fair_problem(params, rho=RHO)
    x0 = broadcast_to_nodes(params, n_nodes)
    y0 = torch.full((n_nodes, 3), 1.0 / 3.0, device=dev)
    spec = GossipSpec(topology="ring", n_nodes=n_nodes, k_steps=k_steps,
                      comm=comm)
    hyper = hyper or GDAHyper(alpha=0.5, beta=0.05, eta=0.2,
                              retraction=retraction)
    opt = OPTIMIZERS[name](problem, spec, hyper, draws=draws)

    full = batch_to_torch(stream.full(n_batches=FULL_BATCHES), dev)
    state = opt.init(x0, y0, full if deterministic
                     else batch_to_torch(stream.batch(0), dev))
    return Run(opt=opt, problem=problem, stream=stream, full=full,
               state=state, device=dev)


def run_method(name: str, steps: int, deterministic: bool, seed: int = 0,
               hyper: GDAHyper | None = None, eval_every: int = 10,
               image_hw: int = 14, n_nodes: int = 20,
               k_steps: int | None = 1, retraction: str = "polar_fused",
               device="cuda", comm: CommSpec | None = None,
               draws=None) -> dict:
    """Train ``steps`` steps (see :func:`prepare` for the arguments) and
    return the curve of loss / M_t / consensus / Stiefel residual, taken
    at step 1, every ``eval_every`` steps and the last step (so the
    "final" numbers are always those of the last step).

    ``deterministic`` feeds every node its full local dataset each step
    (DRGDA's setting), else a fresh minibatch per step.  ``us_per_step``
    is the median time of one optimizer step alone (synchronized; not the
    data or the metric), so the first, warm-up step does not count.
    ``x_bits_per_param_per_mix`` is what one mix of x puts on the wire per
    parameter (32 without compression).
    """
    run = prepare(name, deterministic, seed=seed, hyper=hyper,
                  image_hw=image_hw, n_nodes=n_nodes, k_steps=k_steps,
                  retraction=retraction, device=device, comm=comm,
                  draws=draws)
    dev, state = run.device, run.state
    curve = []
    step_s = []
    for t in range(steps):
        batch = run.full if deterministic \
            else batch_to_torch(run.stream.batch(t + 1), dev)
        synchronize(dev)
        t0 = time.perf_counter()
        state, metrics = run.opt.step(state, batch)
        synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        if (t + 1) % eval_every == 0 or t == 0 or t == steps - 1:
            m = convergence_metric(run.problem, state.x, state.y, run.full)
            curve.append({"step": t + 1, "loss": float(metrics.loss),
                          "M_t": float(m["M_t"]),
                          "consensus_x": float(m["consensus_x"]),
                          "stiefel_residual": float(m["stiefel_residual"])})
    return {"method": name, "deterministic": deterministic, "curve": curve,
            "final_loss": curve[-1]["loss"], "final_M_t": curve[-1]["M_t"],
            "us_per_step": statistics.median(step_s) * 1e6,
            "device": str(dev), "n_nodes": n_nodes, "k": run.opt.k,
            "retraction": run.opt.hyper.retraction,
            "comm": dataclasses.asdict(comm) if comm is not None else None,
            "x_bits_per_param_per_mix": (
                32.0 if run.opt.engine is None
                else run.opt.engine.bits_per_param(state.x))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", choices=sorted(OPTIMIZERS), default="drgda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--stoch", action="store_true",
                    help="fresh minibatches (DRSGDA's setting)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--image-hw", type=int, default=14)
    ap.add_argument("--n-nodes", type=int, default=20)
    ap.add_argument("--k-steps", default="1",
                    help="gossip steps per mix, or 'theorem1'")
    ap.add_argument("--retraction", default="polar_fused")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--comm", choices=sorted(COMM_PRESETS), default="full",
                    help="comms preset; the flags below override its fields")
    ap.add_argument("--compressor", choices=["none", "int8", "topk",
                                             "lowrank"])
    ap.add_argument("--gamma", type=float)
    ap.add_argument("--quant-hops", choices=["first", "all"])
    ap.add_argument("--drop-rate", type=float)
    args = ap.parse_args(argv)
    k = None if args.k_steps == "theorem1" else int(args.k_steps)
    res = run_method(args.method, args.steps, not args.stoch, seed=args.seed,
                     eval_every=args.eval_every, image_hw=args.image_hw,
                     n_nodes=args.n_nodes, k_steps=k,
                     retraction=args.retraction, device=args.device,
                     comm=comm_from_args(args))
    print(json.dumps(res, indent=1))


def comm_from_args(args) -> CommSpec | None:
    """The ``--comm`` preset with the explicit flags applied over it."""
    override = {field: value for field, value in (
        ("compressor", args.compressor), ("gamma", args.gamma),
        ("quant_hops", args.quant_hops), ("drop_rate", args.drop_rate))
        if value is not None}
    comm = COMM_PRESETS[args.comm]
    if not override:
        return comm
    comm = dataclasses.replace(comm or CommSpec(), **override)
    return comm if comm.enabled else None


if __name__ == "__main__":
    main()
