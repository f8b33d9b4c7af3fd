"""Orthonormal fair classification (paper Figs. 1-2): DRGDA / DRSGDA and
the paper's four baselines.

The port's counterpart of ``run_method`` and ``run`` in
``benchmarks/fair_classification.py``: a ring of nodes, the synthetic
classification stream, the CNN with Stiefel ``fc1``/``head``, and M_t every
``eval_every`` steps, for any name of ``repro_torch.core.OPTIMIZERS``
(drgda, drsgda, gt-gda, gnsd-a, dm-hsgd, gt-srvr).  :func:`run_figures`
runs both figures; :func:`load_reference` and :func:`compare_to_reference`
hold them against the JAX package's curves written by
``tests/_reference_curves.py`` (from the same initial weights, which the
file carries, and under the gates it records).  ``comm`` (a
:class:`~repro_torch.comms.spec.CommSpec`) turns on compressed gossip and a
faulty channel; :data:`COMM_PRESETS` are the three variants of the JAX
package's ``benchmarks/comms.py`` ``fair_runs``.

    python -m repro_torch.launch.fair --method drgda --steps 30 --image-hw 28
    python -m repro_torch.launch.fair --method gt-srvr --stoch --steps 30
    python -m repro_torch.launch.fair --retraction cayley --steps 10
    python -m repro_torch.launch.fair --figures
    python -m repro_torch.launch.fair --comm int8_ef --image-hw 28
    python -m repro_torch.launch.fair --compressor int8 --gamma 0.95 \
        --quant-hops all --k-steps theorem1 --steps 5 --image-hw 28

run on the card; ``--device cpu`` runs the plain PyTorch versions of the
kernels instead.
"""
from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.comms.spec import CommSpec
from repro_torch.convert import batch_to_torch, params_from_reference
from repro_torch.core import OPTIMIZERS
from repro_torch.core.baselines import HSGDHyper, SRVRHyper
from repro_torch.core.gda import GDAHyper, broadcast_to_nodes
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
#: the methods of each figure, as the JAX package's ``run()``
FIGURES = {"figure1_deterministic": ("drgda", "gt-gda"),
           "figure2_stochastic": ("drsgda", "gnsd-a", "dm-hsgd", "gt-srvr")}
#: the JAX package's curves of both figures, in a checkout of the repository
REFERENCE = (Path(__file__).resolve().parents[3] / "tests" / "data"
             / "fair_reference_curves.json")


def default_hyper(name: str, retraction: str = "polar_fused"):
    """The hyper-parameters ``benchmarks/fair_classification.py`` gives
    method ``name`` (its lines 52-58), with ``retraction`` for the
    methods that retract."""
    if name == "dm-hsgd":
        return HSGDHyper(beta=0.05, eta=0.2, bx=0.1)
    if name == "gt-srvr":
        return SRVRHyper(beta=0.05, eta=0.2, q=16)
    return GDAHyper(alpha=0.5, beta=0.05, eta=0.2, retraction=retraction)


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
            hyper=None, image_hw: int = 14,
            n_nodes: int = 20, k_steps: int | None = 1,
            retraction: str = "polar_fused", device="cuda",
            comm: CommSpec | None = None, draws=None,
            params: dict | None = None, problem=None,
            stream: ClassificationStream | None = None,
            elastic=None, telemetry=None) -> Run:
    """Build the stream, the CNN, the problem and optimizer ``name`` (a key
    of ``OPTIMIZERS``), and initialize its state.

    ``k_steps=None`` takes the Theorem-1 gossip steps of the ring (the
    baselines mix one hop whatever it is).  ``comm`` routes every mix
    through the comms engine, with ``draws`` as its draw source (default:
    one seeded with ``comm.seed``); ``elastic`` (an
    :class:`~repro_torch.comms.elastic.ElasticSpec`) through the elastic
    engine, with the same ``draws``.  ``hyper`` defaults to
    :func:`default_hyper`, whose retraction is ``retraction``.  ``params``:
    the one node's initial weights every node starts from (port layout;
    default: ``init_cnn`` seeded with ``seed``).  ``problem``: a function of
    the initial weights that returns the problem (default: the fair
    problem at ``RHO``).  ``stream``: the data (default: the classification
    stream of ``n_nodes``, ``BATCH_PER_NODE``, ``image_hw`` and ``seed``;
    a given one sets ``n_nodes`` and ``image_hw``).  ``telemetry``: the
    optimizer's ``repro_torch.obs.Telemetry`` (default none).  GT-SRVR, like the
    others, is initialized on the first batch.  Sets
    ``torch.backends.cuda.matmul.allow_tf32``
    and ``torch.backends.cudnn.allow_tf32`` to False: the system is fp32
    throughout, and TF32 convolutions alone would break trajectory parity
    with the JAX package.
    """
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown method {name!r}; known: "
                         f"{sorted(OPTIMIZERS)}")
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if stream is None:
        stream = ClassificationStream(n_nodes=n_nodes,
                                      batch_per_node=BATCH_PER_NODE,
                                      image_hw=image_hw, seed=seed)
    n_nodes, image_hw = stream.n_nodes, stream.image_hw
    if params is None:
        params = fair.init_cnn(torch.Generator().manual_seed(seed),
                               image_hw=image_hw, device=dev)
    else:
        params = {k: v.to(dev) for k, v in params.items()}
    problem = (problem or _fair_problem)(params)
    x0 = broadcast_to_nodes(params, n_nodes)
    y0 = torch.full((n_nodes, 3), 1.0 / 3.0, device=dev)
    spec = GossipSpec(topology="ring", n_nodes=n_nodes, k_steps=k_steps,
                      comm=comm, elastic=elastic)
    hyper = hyper or default_hyper(name, retraction)
    opt = OPTIMIZERS[name](problem, spec, hyper, draws=draws,
                           telemetry=telemetry)

    full = batch_to_torch(stream.full(n_batches=FULL_BATCHES), dev)
    state = opt.init(x0, y0, full if deterministic
                     else batch_to_torch(stream.batch(0), dev))
    return Run(opt=opt, problem=problem, stream=stream, full=full,
               state=state, device=dev)


def _fair_problem(params: dict):
    return fair.make_fair_problem(params, rho=RHO)


def run_method(name: str, steps: int, deterministic: bool, seed: int = 0,
               hyper=None, eval_every: int = 10,
               image_hw: int = 14, n_nodes: int = 20,
               k_steps: int | None = 1, retraction: str = "polar_fused",
               device="cuda", comm: CommSpec | None = None,
               draws=None, params: dict | None = None) -> dict:
    """Train ``steps`` steps (see :func:`prepare` for the arguments) and
    return the curve of loss / M_t / consensus / Stiefel residual, taken
    at step 1, every ``eval_every`` steps and the last step (so the
    "final" numbers are always those of the last step).

    ``deterministic`` feeds every node its full local dataset each step
    (DRGDA's setting), else a fresh minibatch per step; GT-SRVR takes an
    anchor step on the full datasets at every ``t % q == 0``.  ``us_per_step``
    is the median time of one optimizer step alone (synchronized; not the
    data or the metric), so the first, warm-up step does not count.
    ``x_bits_per_param_per_mix`` is what one mix of x puts on the wire per
    parameter (32 without compression).
    """
    run = prepare(name, deterministic, seed=seed, hyper=hyper,
                  image_hw=image_hw, n_nodes=n_nodes, k_steps=k_steps,
                  retraction=retraction, device=device, comm=comm,
                  draws=draws, params=params)
    dev, state = run.device, run.state
    curve = []
    step_s = []
    for t in range(steps):
        batch = run.full if deterministic \
            else batch_to_torch(run.stream.batch(t + 1), dev)
        anchor = name == "gt-srvr" and t % run.opt.hyper.q == 0
        synchronize(dev)
        t0 = time.perf_counter()
        if anchor:
            state, metrics = run.opt.anchor_step(state, run.full)
        else:
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
            "retraction": getattr(run.opt.hyper, "retraction", None),
            "comm": dataclasses.asdict(comm) if comm is not None else None,
            "x_bits_per_param_per_mix": (
                32.0 if run.opt.engine is None
                else run.opt.engine.bits_per_param(state.x))}


def run_figures(steps_det: int = 120, steps_stoch: int = 150, seed: int = 0,
                image_hw: int = 14, n_nodes: int = 20, eval_every: int = 10,
                device="cuda", params: dict | None = None) -> dict:
    """Paper Figs. 1-2, the counterpart of the JAX package's ``run()``:
    DRGDA and GT-GDA on full local datasets for ``steps_det`` steps, DRSGDA,
    GNSD-A, DM-HSGD and GT-SRVR on minibatches for ``steps_stoch``, each at
    :func:`default_hyper` with the JAX package's default retraction,
    ``"polar"``."""
    return {fig: [run_method(name, steps_det if fig.startswith("figure1")
                             else steps_stoch,
                             fig.startswith("figure1"), seed=seed,
                             eval_every=eval_every, image_hw=image_hw,
                             n_nodes=n_nodes, retraction="polar",
                             device=device, params=params)
                  for name in names]
            for fig, names in FIGURES.items()}


def decode(v: dict) -> np.ndarray:
    """An array of a reference file: float32 little-endian in base64."""
    return np.frombuffer(base64.b64decode(v["float32_base64"]),
                         dtype="<f4").reshape(v["shape"])


def load_reference(path) -> dict:
    """A curves file of the JAX package (``tests/_reference_curves.py``),
    with ``init_params`` decoded into the port's layout on the CPU."""
    ref = json.loads(Path(path).read_text())
    ref["init_params"] = params_from_reference(
        {k: decode(v) for k, v in ref["init_params"].items()}, "cpu")
    return ref


def run_reference_figures(reference: dict, device="cuda") -> dict:
    """:func:`run_figures` at the settings of a :func:`load_reference`
    file, from its initial weights."""
    s = reference["settings"]
    return run_figures(s["steps_det"], s["steps_stoch"], seed=s["seed"],
                       image_hw=s["image_hw"], n_nodes=s["n_nodes"],
                       eval_every=s["eval_every"], device=device,
                       params=reference["init_params"])


#: quantities whose gap is absolute: rounding noise (the Stiefel residual)
#: or an angle near 0, where fp32 rounding of a cosine near 1 is about 5e-4
ABSOLUTE = ("stiefel_residual", "angle")


def _gap(a: dict, b: dict, key: str) -> float:
    """Curve point ``a``'s gap from the reference's ``b``: relative to the
    reference's value, absolute for the quantities of :data:`ABSOLUTE`."""
    if key in ABSOLUTE:
        return abs(a[key] - b[key])
    return abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)


def compare_curves(runs: list, ref_runs: list, tolerance: dict) -> dict:
    """Each run's curve against the reference run of its method, point by
    point, under the gates of ``tolerance`` (method -> quantity -> one gate
    per curve point; null where the point is reported and not gated).  Per
    method and quantity: the largest gap over the gated points (``gated``)
    and over the others (``reported``, None if every point is gated), the
    last gated step (``gated_through``), and every gated point over its
    gate (``over``: step, gap, gate).  The two must have the same methods
    and curve steps."""
    runs = {r["method"]: r for r in runs}
    out = {}
    for ref_run in ref_runs:
        name = ref_run["method"]
        got, want = runs[name]["curve"], ref_run["curve"]
        if [p["step"] for p in got] != [p["step"] for p in want]:
            raise ValueError(f"{name}: curve steps differ")
        out[name] = {}
        for key, gates in tolerance[name].items():
            points = [(b["step"], _gap(a, b, key), gate)
                      for a, b, gate in zip(got, want, gates)]
            gated = [p for p in points if p[2] is not None]
            rest = [p[1] for p in points if p[2] is None]
            out[name][key] = {
                "gated": max(p[1] for p in gated) if gated else None,
                "reported": max(rest) if rest else None,
                "gated_through": gated[-1][0] if gated else None,
                "over": [p for p in gated if p[1] > p[2]]}
    return out


def compare_to_reference(figures: dict, reference: dict) -> dict:
    """The curves of :func:`run_figures` against the reference's, figure
    by figure (:func:`compare_curves`)."""
    out = {}
    for fig, ref_runs in reference["figures"].items():
        out.update(compare_curves(figures[fig], ref_runs,
                                  reference["tolerance"]))
    return out


def within_reference(comparison: dict) -> bool:
    """Whether every gated point of :func:`compare_to_reference` is inside
    its gate."""
    return not any(per_key["over"] for per_method in comparison.values()
                   for per_key in per_method.values())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", choices=sorted(OPTIMIZERS), default="drgda")
    ap.add_argument("--figures", action="store_true",
                    help="run both paper figures (all six methods)")
    ap.add_argument("--reference", default=str(REFERENCE),
                    help="with --figures: the JAX package's curves file, "
                         "whose settings, initial weights and gates the "
                         "run takes")
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
    if args.figures:
        ref = load_reference(args.reference)
        res = run_reference_figures(ref, args.device)
        print(json.dumps(res, indent=1))
        comparison = compare_to_reference(res, ref)
        print(json.dumps({"comparison": comparison,
                          "within_reference": within_reference(comparison)}))
        return
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
