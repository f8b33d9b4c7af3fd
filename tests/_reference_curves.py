"""Write the JAX package's curves of paper Figs. 1-2 to a file, for the
port to be held against on a machine without JAX.

    PYTHONPATH=src python tests/_reference_curves.py

runs ``run()`` of ``benchmarks/fair_classification.py`` (DRGDA and GT-GDA on
full local datasets for 120 steps, DRSGDA, GNSD-A, DM-HSGD and GT-SRVR on
minibatches for 150; a 20-node ring, seed 0), then the same runs
``ENSEMBLE`` times more from perturbed initial weights, and writes
``tests/data/fair_reference_curves.json``:

* ``settings``: what the runs were (read from the benchmark where it names
  them: its defaults, ``N_NODES``, ``RHO``, the stream's image size);
* ``init_params``: the one node's initial weights every node starts from
  (``fair.init_cnn`` with ``jax.random.PRNGKey(seed)``; the port cannot
  draw them), float32 little-endian in base64, conv kernels in HWIO;
* ``figures``: each method's curve (loss, M_t, consensus_x,
  stiefel_residual at step 1 and every ``eval_every`` steps), without the
  benchmark's ``us_per_step`` (a time of this machine's CPU);
* ``spread``: how far the JAX package moves from itself at each curve
  point under a perturbation of its initial weights of the size of fp32
  rounding (see :data:`ENSEMBLE`);
* ``tolerance``: the gate of each curve point, from the spread and the
  port's CPU gap (see :func:`tolerance`).

It takes about 12 minutes on a CPU.  It imports the JAX package and the
benchmark, and nothing of the port.
"""
from __future__ import annotations

import base64
import importlib.util
import inspect
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "fair_reference_curves.json"
QUANTITIES = ("loss", "M_t", "consensus_x", "stiefel_residual")
FIGURES = {"figure1_deterministic": ["drgda", "gt-gda"],
           "figure2_stochastic": ["drsgda", "gnsd-a", "dm-hsgd", "gt-srvr"]}

# The gate is taken from the reference itself.  ``ENSEMBLE`` more runs of
# the JAX package start from its initial weights multiplied by (1 + 1e-7
# standard normal noise), the size of fp32 rounding; a curve point's
# *spread* is the largest gap of those runs from the unperturbed one there
# (as :func:`gap` counts it).  Where the reference reproduces itself to
# ``SPREAD_CAP``, its points are gated at ``SPREAD_FACTOR`` times the
# spread; from the first point of a method's quantity where the spread
# passes the cap on, the reference cannot tell a faulty port from rounding,
# and those points are reported, not gated (a null gate).  GT-SRVR and
# GT-GDA amplify rounding this way: their late points spread by O(1).
ENSEMBLE = 4
PERTURBATION = 1e-7
SPREAD_FACTOR = 10.0
SPREAD_CAP = 1e-3
# The port's largest gap from the reference on the CPU over the gated
# points, per method and quantity (relative), measured once with
# `python -m repro_torch.launch.fair --figures --device cpu`; the gate is
# never below ten times it, nor below 1e-4 relative.  The Stiefel residual
# (|x^T x - I|, rounding noise of about 1e-6 that two implementations do
# not share) is held at every point to 1e-4 absolute, the feasibility bound
# every curve point of the port is held to.
CPU_GAP = {
    "drgda": {"loss": 1.363e-05, "M_t": 3.889e-05, "consensus_x": 2.645e-05},
    "gt-gda": {"loss": 1.371e-05, "M_t": 5.234e-04, "consensus_x": 8.243e-05},
    "drsgda": {"loss": 4.345e-06, "M_t": 1.662e-05, "consensus_x": 3.338e-06},
    "gnsd-a": {"loss": 7.360e-07, "M_t": 6.961e-06, "consensus_x": 3.461e-04},
    "dm-hsgd": {"loss": 2.157e-05, "M_t": 2.343e-04,
                "consensus_x": 2.624e-04},
    "gt-srvr": {"loss": 0.0, "M_t": 1.697e-06, "consensus_x": 2.111e-06},
}
CPU_FACTOR = 10.0
FLOOR = 1e-4
RESIDUAL_GATE = 1e-4


def benchmark():
    """``benchmarks/fair_classification.py`` as a module (the folder is
    not a package)."""
    sys.path.insert(0, str(ROOT / "src"))
    path = ROOT / "benchmarks" / "fair_classification.py"
    spec = importlib.util.spec_from_file_location("fair_classification", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _defaults(fn) -> dict:
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


def settings(fc) -> dict:
    """What ``fc.run()`` runs, from the benchmark's own definitions where
    it names them; the hyper-parameters are the ones its ``run_method``
    builds for each method (fair_classification.py:52-58)."""
    import dataclasses

    from repro.core.baselines import HSGDHyper, SRVRHyper
    from repro.core.gda import GDAHyper
    from repro.data.synthetic import ClassificationStream

    run, method, setup = (_defaults(fc.run), _defaults(fc.run_method),
                          _defaults(fc._setup))
    gda = dataclasses.asdict(GDAHyper(alpha=0.5, beta=0.05, eta=0.2))
    hyper = {name: gda for names in FIGURES.values() for name in names}
    hyper["dm-hsgd"] = dataclasses.asdict(HSGDHyper(beta=0.05, eta=0.2,
                                                    bx=0.1))
    hyper["gt-srvr"] = dataclasses.asdict(SRVRHyper(beta=0.05, eta=0.2,
                                                    q=16))
    return {
        "source": "benchmarks/fair_classification.py run()",
        "n_nodes": fc.N_NODES, "topology": "ring", "k_steps": 1,
        "rho": fc.RHO, "seed": method["seed"],
        "batch_per_node": setup["batch_per_node"],
        "image_hw": _defaults(ClassificationStream)["image_hw"],
        "full_batches": 4,
        "steps_det": run["steps_det"], "steps_stoch": run["steps_stoch"],
        "eval_every": method["eval_every"],
        "figures": FIGURES, "hyper": hyper,
    }


def tolerance(spread: dict) -> dict:
    """The gate of every curve point, per method and quantity: a list
    beside the curve, null where the point is reported and not gated."""
    out = {}
    for name, per_key in spread.items():
        out[name] = {}
        for key, points in per_key.items():
            gates, open_ = [], True
            for sp in points:
                open_ = open_ and sp <= SPREAD_CAP
                gates.append(max(SPREAD_FACTOR * sp,
                                 CPU_FACTOR * CPU_GAP[name][key], FLOOR)
                             if open_ else None)
            out[name][key] = gates
        n = len(next(iter(per_key.values())))
        out[name]["stiefel_residual"] = [RESIDUAL_GATE] * n
    return out


def _encode(a) -> dict:
    import numpy as np
    a = np.ascontiguousarray(np.asarray(a, dtype="<f4"))
    return {"shape": list(a.shape),
            "float32_base64": base64.b64encode(a.tobytes()).decode()}


def gap(a: dict, b: dict, key: str) -> float:
    """The gap of curve point ``a`` from the reference's ``b``: relative to
    the reference's value, absolute for the Stiefel residual (rounding
    noise of about 1e-6 that two implementations do not share)."""
    if key == "stiefel_residual":
        return abs(a[key] - b[key])
    return abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)


def spread(fc, s: dict, figures: dict) -> dict:
    """The reference's own spread at every curve point, per method and
    quantity: the largest gap of ``ENSEMBLE`` runs from perturbed initial
    weights (see :data:`ENSEMBLE`) from ``figures``."""
    import jax.numpy as jnp
    import numpy as np

    setup = fc._setup
    out = {r["method"]: {key: [0.0] * len(r["curve"])
                         for key in QUANTITIES[:3]}
           for runs in figures.values() for r in runs}
    for member in range(ENSEMBLE):
        rng = np.random.default_rng(member + 1)

        def perturbed(seed=0, **kw):
            stream, problem, x0, y0 = setup(seed, **kw)
            x0 = {k: v * jnp.asarray(1.0 + PERTURBATION * rng.standard_normal(
                v.shape[1:]), v.dtype)[None] for k, v in x0.items()}
            return stream, problem, x0, y0

        fc._setup = perturbed
        try:
            got = fc.run(s["steps_det"], s["steps_stoch"])
        finally:
            fc._setup = setup
        for fig, runs in figures.items():
            for r, want in zip(got[fig], runs):
                for key, points in out[r["method"]].items():
                    for i, (a, b) in enumerate(zip(r["curve"],
                                                   want["curve"])):
                        points[i] = max(points[i], gap(a, b, key))
        print(f"ensemble member {member + 1} of {ENSEMBLE} done", flush=True)
    return out


def main() -> None:
    os.environ.setdefault("REPRO_TUNE", "off")
    fc = benchmark()
    s = settings(fc)
    x0 = fc._setup(s["seed"])[2]
    init = {k: _encode(v[0]) for k, v in sorted(x0.items())}
    out = fc.run(s["steps_det"], s["steps_stoch"])
    figures = {}
    for fig, names in FIGURES.items():
        got = [r["method"] for r in out[fig]]
        if got != names:
            raise RuntimeError(f"{fig}: the benchmark ran {got}, not {names}")
        figures[fig] = [{"method": r["method"],
                         "deterministic": r["deterministic"],
                         "curve": r["curve"]} for r in out[fig]]
    sp = spread(fc, s, figures)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"settings": s, "spread": sp,
                               "tolerance": tolerance(sp),
                               "init_params": init, "figures": figures},
                              indent=1) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
