"""The paper's supplementary experiment: distributionally robust
optimization with orthonormal weights (Eq. 21), DRSGDA against GNSD-A and
DM-HSGD on the heterogeneous classification stream, ring of n = 20.

The port's counterpart of ``benchmarks/dro.py``: the stream at
``hetero=0.9`` (its default 14x14 images, 32 per node), ``fair.make_dro_problem``,
y0 = 1/3, ``HSGDHyper(beta=0.05, eta=0.2)`` for DM-HSGD and
``GDAHyper(alpha=0.5, beta=0.05, eta=0.2)`` (retraction ``"polar"``) for the
others, initialized on ``stream.batch(0)``, step t on ``stream.batch(t + 1)``,
and M_t on ``stream.full(2)`` after the first step and every 10th.  The
CLI runs the reference's settings from its initial weights and prints the
curves and their gaps.
:func:`run` gives DM-HSGD half the steps (two gradient passes a step: an
equal sample budget).  :func:`load_reference` and
:func:`compare_to_reference` hold the curves against the JAX package's
(``tests/data/dro_reference_curves.json``, from the same initial weights,
under the gates it records).

    python -m repro_torch.launch.dro                 # on the card
    python -m repro_torch.launch.dro --device cpu
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

from repro_torch.convert import batch_to_torch
from repro_torch.core.baselines import HSGDHyper
from repro_torch.core.gda import GDAHyper
from repro_torch.core.metric import convergence_metric
from repro_torch.data.synthetic import ClassificationStream
from repro_torch.launch import fair, synchronize
from repro_torch.objectives.fair import make_dro_problem

N_NODES = 20
BATCH_PER_NODE = 32
HETERO = 0.9
EVAL_BATCHES = 2
EVAL_EVERY = 10
METHODS = ("drsgda", "gnsd-a", "dm-hsgd")
#: the JAX package's curves, in a checkout of the repository
REFERENCE = (Path(__file__).resolve().parents[3] / "tests" / "data"
             / "dro_reference_curves.json")


def hyper(name: str):
    """The hyper-parameters ``benchmarks/dro.py`` gives method ``name``."""
    if name == "dm-hsgd":
        return HSGDHyper(beta=0.05, eta=0.2)
    return GDAHyper(alpha=0.5, beta=0.05, eta=0.2, retraction="polar")


def run_method(name: str, steps: int, seed: int = 0, device="cuda",
               n_nodes: int = N_NODES, params: dict | None = None) -> dict:
    """Train method ``name`` for ``steps`` minibatch steps on the DRO
    problem and return its curve: loss, M_t, ``worst_group_weight`` (the
    largest entry of the node-stacked y) and the Stiefel residual, after
    the first step and every 10th.  ``params``: the one node's initial
    weights (port layout; default ``init_cnn`` seeded with ``seed``).
    ``us_per_step``: the median synchronized step."""
    stream = ClassificationStream(n_nodes=n_nodes,
                                  batch_per_node=BATCH_PER_NODE, seed=seed,
                                  hetero=HETERO)
    run = fair.prepare(name, False, seed=seed, hyper=hyper(name),
                       device=device, params=params,
                       problem=make_dro_problem, stream=stream)
    dev, state = run.device, run.state
    evaluate = batch_to_torch(stream.full(EVAL_BATCHES), dev)
    curve, step_s = [], []
    for t in range(steps):
        batch = batch_to_torch(stream.batch(t + 1), dev)
        synchronize(dev)
        t0 = time.perf_counter()
        state, metrics = run.opt.step(state, batch)
        synchronize(dev)
        step_s.append(time.perf_counter() - t0)
        if (t + 1) % EVAL_EVERY == 0 or t == 0:
            m = convergence_metric(run.problem, state.x, state.y, evaluate)
            curve.append({"step": t + 1, "loss": float(metrics.loss),
                          "M_t": float(m["M_t"]),
                          "worst_group_weight": float(state.y.max()),
                          "stiefel_residual": float(m["stiefel_residual"])})
    return {"method": name, "curve": curve,
            "final_loss": curve[-1]["loss"], "final_M_t": curve[-1]["M_t"],
            "us_per_step": statistics.median(step_s) * 1e6,
            "device": str(dev)}


def run(steps: int = 120, seed: int = 0, device="cuda",
        params: dict | None = None) -> dict:
    """DRSGDA and GNSD-A for ``steps`` steps, DM-HSGD for half as many."""
    return {"dro": [run_method(name, steps // 2 if name == "dm-hsgd"
                               else steps, seed=seed, device=device,
                               params=params) for name in METHODS]}


def load_reference(path=REFERENCE) -> dict:
    """The JAX package's DRO curves file, with ``init_params`` in the
    port's layout on the CPU."""
    return fair.load_reference(path)


def run_reference(reference: dict, device="cuda") -> dict:
    """:func:`run` at the settings of a :func:`load_reference` file, from
    its initial weights."""
    s = reference["settings"]
    return run(s["steps"], seed=s["seed"], device=device,
               params=reference["init_params"])


def compare_to_reference(result: dict, reference: dict) -> dict:
    """:func:`run`'s curves against the reference's, point by point, under
    the gates it records (``fair.compare_curves``)."""
    return fair.compare_curves(result["dro"], reference["dro"],
                               reference["tolerance"])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ref = load_reference()
    res = run_reference(ref, args.device)
    print(json.dumps(res, indent=1))
    comparison = compare_to_reference(res, ref)
    print(json.dumps({"comparison": comparison,
                      "within_reference": fair.within_reference(comparison)}))


if __name__ == "__main__":
    main()
