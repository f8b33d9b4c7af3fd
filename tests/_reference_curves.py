"""Write the JAX package's runs to files, for the port to be held against
on a machine without JAX.

    PYTHONPATH=src python tests/_reference_curves.py [fair] [dro] \
        [robust_pca] [elastic] [lm] [lm_models]

(all six without arguments; ``<target>_retolerance``, e.g.
``fair_retolerance``, rewrites that target's gates from its stored spread
without running JAX, after its CPU gaps are re-measured).  Each target runs the JAX package, then the
same run ``ENSEMBLE`` times more from perturbed initial weights, and
records the reference's own spread and a gate beside every curve point.

``fair``: ``run()`` of ``benchmarks/fair_classification.py`` (DRGDA and
GT-GDA on full local datasets for 120 steps, DRSGDA, GNSD-A, DM-HSGD and
GT-SRVR on minibatches for 150; a 20-node ring, seed 0), written to
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

``dro``: ``run()`` of ``benchmarks/dro.py`` (DRSGDA and GNSD-A for 120
steps, DM-HSGD for 60, on the stream at ``hetero=0.9``), written to
``tests/data/dro_reference_curves.json``: ``settings`` (read from the
benchmark), ``init_params``, the curves under ``dro`` (loss, M_t,
worst_group_weight, and the Stiefel residual, which the benchmark computes
and drops: :func:`residuals_recorded`), ``spread`` and ``tolerance``.

``robust_pca``: the run of ``examples/robust_pca.py`` (DRGDA on Gr(20, 3),
8-node ring, 800 steps), rebuilt from the settings read with ``ast`` from
the example's source (importing the example runs it), written to
``tests/data/robust_pca_reference.json``: ``settings``, the arrays
``batches`` (z), ``true_basis`` and ``x0`` made with the example's keys,
the curve (after step t = 0, 200, 400, 600 and after the last step: loss,
M_t, consensus_x, stiefel_residual, angle to the planted subspace), the
worst-case objective ``phi`` of DRGDA and of pooled PCA, ``spread`` and
``tolerance``.

``elastic``: ``run()`` of ``benchmarks/elastic.py`` (DRGDA on an 8-node
ring under six churn schedules, fair classification for 60 steps and
robust PCA for 200), written to ``tests/data/elastic_reference.json``:
``settings`` (read from the benchmark), ``init_params`` (the CNN's
``init_cnn(PRNGKey(0))``), the robust-PCA data ``pca_batches`` (z) and
start ``pca_x0`` made with the benchmark's keys, the runs under
``fair_classification`` and ``robust_pca`` (curves with loss, M_t,
consensus_x, the Stiefel residual and the live-node trace), ``draws``
(the uniforms behind every churn and straggler draw of the runs, per
round: ``churn`` leave and join,
``straggle`` per slot; the port cannot draw them), ``spread`` and
``tolerance``.  The ensemble perturbs the initial weights and the PCA
start; the churn draws do not depend on them, so every member sees the
same membership.

``lm``: the JAX trainer of ``launch/train.py`` (``build_trainer``'s
default hyper, DRSGDA on a 4-node ring) on smollm-135m at its published
widths cut to 2 layers, 2 sequences of 64 tokens a node, 10 steps, from
``repro_torch.convert.lm_params_from_seed`` (NumPy draws both packages
take), written to ``tests/data/lm_reference.json``: ``settings``, every
step's ``steps`` (loss, grad_norm_x, consensus_x), ``evals`` at steps 5
and 10 (M_t, stiefel_residual, on the step's batch as the CLI takes
them), ``spread`` and ``tolerance`` (:data:`LM_CPU_GAP`).  Scalars only:
the weights are rebuilt from the seed.

``lm_models``: the same trainer and settings as ``lm`` for four more
architectures, written to ``tests/data/lm_models_reference.json`` under
``runs``, one entry each with the keys of ``lm``'s file:
granite-moe-1b-a400m and musicgen-large at their published widths cut to
2 layers (the weights of ``convert.lm_params_from_seed``),
deepseek-v2-236b and llama-3.2-vision-11b at ``SMOKE``, the latter's
frontend embeddings from ``convert.lm_frontend_from_seed`` (the same in
every batch); gates from :data:`LM_MODELS_CPU_GAP`.  Each run is written
as soon as it and its ensemble are done; ``lm_models:<arch>`` records one.

``fair`` takes about 12 minutes on a CPU, ``dro`` about 6, ``robust_pca``
about 1, ``lm`` about 15 (about 10 GB of memory); ``lm_models`` about
135 (musicgen-large about 100: the Newton–Schulz products of its 2048 x
2048 Stiefel leaves; granite-moe-1b-a400m about 30 and 26 GB of memory).  The script imports the
JAX package and the benchmarks, and of the port only the NumPy
initializer ``convert.lm_params_from_seed``.
"""
from __future__ import annotations

import ast
import base64
import contextlib
import dataclasses
import importlib.util
import inspect
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "fair_reference_curves.json"
DRO_OUT = ROOT / "tests" / "data" / "dro_reference_curves.json"
PCA_OUT = ROOT / "tests" / "data" / "robust_pca_reference.json"
ELASTIC_OUT = ROOT / "tests" / "data" / "elastic_reference.json"
ELASTIC_QUANTITIES = ("loss", "M_t", "consensus_x")
ELASTIC_SLOTS = ("x", "y", "u", "v")
EXAMPLE = ROOT / "examples" / "robust_pca.py"
DRO_QUANTITIES = ("loss", "M_t", "worst_group_weight")
PCA_QUANTITIES = ("loss", "M_t", "consensus_x", "angle")
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
# (|x^T x - I|, about 7e-6 here: rounding noise that two implementations
# do not share) is absolute, its gap measured over every point of the same
# run, and its gate is ten times that gap at every point, with no floor:
# a floor of 1e-4 lay above the residual itself and could not fail.
CPU_GAP = {
    "drgda": {"loss": 1.363e-05, "M_t": 3.889e-05, "consensus_x": 2.645e-05,
              "stiefel_residual": 9.162e-07},
    "gt-gda": {"loss": 1.371e-05, "M_t": 5.234e-04, "consensus_x": 8.243e-05,
               "stiefel_residual": 7.691e-07},
    "drsgda": {"loss": 4.345e-06, "M_t": 1.662e-05, "consensus_x": 3.338e-06,
               "stiefel_residual": 6.243e-07},
    "gnsd-a": {"loss": 7.360e-07, "M_t": 6.961e-06, "consensus_x": 3.461e-04,
               "stiefel_residual": 1.164e-06},
    "dm-hsgd": {"loss": 2.157e-05, "M_t": 2.343e-04,
                "consensus_x": 2.624e-04, "stiefel_residual": 7.734e-07},
    "gt-srvr": {"loss": 0.0, "M_t": 1.697e-06, "consensus_x": 2.111e-06,
                "stiefel_residual": 1.287e-06},
}
# The same for the DRO curves (`python -m repro_torch.launch.dro --device
# cpu`) and the robust-PCA example (`python -m repro_torch.launch.robust_pca
# --device cpu --reference`; ``phi``: the worst-case objective of DRGDA and
# of pooled PCA, relative).  The angle to the planted subspace is held
# absolutely: fp32 rounding of a cosine near 1 moves a small principal
# angle by about 5e-4 (arccos(1 - delta) ~ sqrt(2 delta)), so its floor is
# ``ANGLE_FLOOR``, not ``FLOOR``.
DRO_CPU_GAP = {
    "drsgda": {"loss": 2.376e-06, "M_t": 6.641e-06,
               "worst_group_weight": 1.310e-07,
               "stiefel_residual": 7.913e-07},
    "gnsd-a": {"loss": 4.045e-03, "M_t": 1.193e-02,
               "worst_group_weight": 1.405e-02,
               "stiefel_residual": 9.415e-07},
    "dm-hsgd": {"loss": 8.412e-07, "M_t": 1.482e-06,
                "worst_group_weight": 1.755e-07,
                "stiefel_residual": 9.435e-07},
}
PCA_CPU_GAP = {
    "drgda": {"loss": 1.535e-07, "M_t": 2.538e-03, "consensus_x": 6.626e-04,
              "angle": 1.967e-06, "stiefel_residual": 1.414e-07},
    "phi": {"drgda": 0.0, "pca": 1.175e-07},
}
# The same for the elastic runs (`python -m repro_torch.launch.elastic
# --device cpu`, replaying the recorded draws), per problem and schedule.
# The DRO and elastic Stiefel residuals are the JAX runs' own, recorded
# beside the benchmarks' curves (:func:`residuals_recorded`); their gaps
# are absolute, over every point, and gate at ten times, as the figures'.
ELASTIC_CPU_GAP = {
    "fair_classification": {
        "static": {"loss": 7.048e-04, "M_t": 1.514e-04,
                  "consensus_x": 7.239e-04, "stiefel_residual": 4.240e-07},
        "leave_rejoin": {"loss": 1.362e-05, "M_t": 2.127e-05,
                        "consensus_x": 1.669e-05, "stiefel_residual": 1.207e-06},
        "random_5pct": {"loss": 6.790e-04, "M_t": 6.728e-04,
                       "consensus_x": 7.521e-04, "stiefel_residual": 3.405e-07},
        "random_20pct": {"loss": 4.801e-05, "M_t": 9.419e-05,
                        "consensus_x": 2.721e-04, "stiefel_residual": 5.337e-07},
        "straggle_tau0": {"loss": 2.697e-07, "M_t": 5.403e-07,
                         "consensus_x": 2.021e-06, "stiefel_residual": 2.419e-07},
        "straggle_tau2": {"loss": 2.259e-06, "M_t": 5.875e-04,
                         "consensus_x": 2.396e-04, "stiefel_residual": 5.864e-07},
    },
    "robust_pca": {
        "static": {"loss": 4.615e-06, "M_t": 2.611e-06,
                  "consensus_x": 1.068e-06, "stiefel_residual": 1.503e-07},
        "leave_rejoin": {"loss": 5.028e-06, "M_t": 6.919e-07,
                        "consensus_x": 2.648e-06, "stiefel_residual": 2.051e-07},
        "random_5pct": {"loss": 1.198e-07, "M_t": 2.775e-07,
                       "consensus_x": 1.326e-05, "stiefel_residual": 1.246e-07},
        "random_20pct": {"loss": 1.530e-07, "M_t": 2.785e-07,
                        "consensus_x": 2.486e-05, "stiefel_residual": 1.829e-07},
        "straggle_tau0": {"loss": 2.769e-07, "M_t": 5.164e-06,
                         "consensus_x": 2.181e-06, "stiefel_residual": 1.272e-07},
        "straggle_tau2": {"loss": 8.347e-07, "M_t": 5.538e-06,
                         "consensus_x": 2.041e-05, "stiefel_residual": 1.340e-07},
    },
}
CPU_FACTOR = 10.0
FLOOR = 1e-4
ANGLE_FLOOR = 1e-3
ABSOLUTE = ("stiefel_residual", "angle")


def benchmark(name: str = "fair_classification"):
    """``benchmarks/<name>.py`` as a module (the folder is not a
    package)."""
    sys.path.insert(0, str(ROOT / "src"))
    path = ROOT / "benchmarks" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
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


def tolerance(spread: dict, cpu_gap: dict | None = None,
              residual: bool = True) -> dict:
    """The gate of every curve point, per method and quantity: a list
    beside the curve, null where the point is reported and not gated.
    ``cpu_gap`` defaults to the figures' :data:`CPU_GAP`; ``residual``
    adds the Stiefel residual's gate at every point: ten times the port's
    CPU gap (``cpu_gap[name]["stiefel_residual"]``, absolute), with no
    floor (the JAX runs record no spread of it)."""
    cpu_gap = CPU_GAP if cpu_gap is None else cpu_gap
    out = {}
    for name, per_key in spread.items():
        out[name] = {}
        for key, points in per_key.items():
            floor = ANGLE_FLOOR if key == "angle" else FLOOR
            gates, open_ = [], True
            for sp in points:
                open_ = open_ and sp <= SPREAD_CAP
                gates.append(max(SPREAD_FACTOR * sp,
                                 CPU_FACTOR * cpu_gap[name][key], floor)
                             if open_ else None)
            out[name][key] = gates
        if residual:
            n = len(next(iter(per_key.values())))
            out[name]["stiefel_residual"] = [
                CPU_FACTOR * cpu_gap[name]["stiefel_residual"]] * n
    return out


def _encode(a) -> dict:
    import numpy as np
    a = np.ascontiguousarray(np.asarray(a, dtype="<f4"))
    return {"shape": list(a.shape),
            "float32_base64": base64.b64encode(a.tobytes()).decode()}


def gap(a: dict, b: dict, key: str) -> float:
    """The gap of curve point ``a`` from the reference's ``b``: relative to
    the reference's value, absolute for the Stiefel residual (rounding
    noise of about 1e-6 that two implementations do not share) and for the
    angle to the planted subspace (see :data:`ANGLE_FLOOR`)."""
    if key in ABSOLUTE:
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


def fair_main() -> None:
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


def _ensemble_gaps(out: dict, member_runs, want_runs, quantities) -> None:
    """Raise ``out[method][key][i]`` to each member run's gap there."""
    for r, want in zip(member_runs, want_runs):
        for key in quantities:
            points = out[r["method"]][key]
            for i, (a, b) in enumerate(zip(r["curve"], want["curve"])):
                points[i] = max(points[i], gap(a, b, key))


# ---------------------------------------------------------------------------
# DRO (benchmarks/dro.py)
# ---------------------------------------------------------------------------


def _calls(tree: ast.AST) -> dict:
    """name -> (positional args, keywords) of the last call of each
    function or method name in ``tree``."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            out[name] = (node.args, {k.arg: k.value for k in node.keywords})
    return out


def _literal(node: ast.AST, names: dict):
    """A constant, a name of ``names``, or ``PRNGKey(seed)`` (its seed)."""
    if isinstance(node, ast.Name):
        return names[node.id]
    if isinstance(node, ast.Call):
        return _literal(node.args[0], names)
    return ast.literal_eval(node)


def dro_settings(dro) -> dict:
    """What ``dro.run()`` runs, read from the benchmark: ``N_NODES``, the
    defaults of ``run`` and ``run_method``, the stream's and the
    hyper-parameters' arguments in ``run_method``, the evaluation batch, and
    each method's steps as ``run`` computes them from its ``steps``."""
    from repro.core.baselines import HSGDHyper
    from repro.core.gda import GDAHyper
    from repro.data.synthetic import ClassificationStream

    tree = ast.parse(inspect.getsource(dro))
    calls = _calls(tree)
    stream = {k: _literal(v, {}) for k, v in calls["ClassificationStream"][1]
              .items() if k not in ("n_nodes", "seed")}
    stream.setdefault("image_hw", _defaults(ClassificationStream)["image_hw"])
    hsgd = {k: _literal(v, {}) for k, v in calls["HSGDHyper"][1].items()}
    gda = {k: _literal(v, {}) for k, v in calls["GDAHyper"][1].items()}
    steps = _defaults(dro.run)["steps"]
    methods = {}
    for node in ast.walk(ast.parse(inspect.getsource(dro.run))):
        if isinstance(node, ast.Call) and getattr(node.func, "id",
                                                  None) == "run_method":
            methods[ast.literal_eval(node.args[0])] = eval(  # noqa: S307
                compile(ast.Expression(node.args[1]), "run", "eval"),
                {"steps": steps})
    return {
        "source": "benchmarks/dro.py run()",
        "n_nodes": dro.N_NODES, "topology": "ring", "k_steps": 1,
        "seed": _defaults(dro.run_method)["seed"], "steps": steps,
        "stream": stream, "y0": 1.0 / 3.0,
        "eval_batches": next(
            ast.literal_eval(node.args[0]) for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "full"
            and getattr(node.func.value, "id", None) == "stream"),
        "eval_every": 10,
        "methods": methods,
        "hyper": {name: dataclasses.asdict(HSGDHyper(**hsgd)
                                           if name == "dm-hsgd"
                                           else GDAHyper(**gda))
                  for name in methods},
    }


def dro_tolerance(spread: dict) -> dict:
    """The gates of the DRO curves, the Stiefel residual's (recorded by
    :func:`residuals_recorded`) at ten times the port's CPU gap."""
    return tolerance(spread, DRO_CPU_GAP)


@contextlib.contextmanager
def residuals_recorded(module, runner: str):
    """Inside the context, every curve point of ``module.<runner>`` (a
    function that returns ``{"curve": [...], ...}`` and calls
    ``module.convergence_metric`` once per point, in order) also carries
    the Stiefel residual that call computed: the benchmarks record the
    metric's other terms and drop this one."""
    metric, drive = module.convergence_metric, getattr(module, runner)
    seen = []

    def recording(*args, **kw):
        m = metric(*args, **kw)
        seen.append(float(m["stiefel_residual"]))
        return m

    def driving(*args, **kw):
        seen.clear()
        out = drive(*args, **kw)
        if len(seen) != len(out["curve"]):
            raise RuntimeError(f"{runner}: {len(seen)} metric calls for "
                               f"{len(out['curve'])} curve points")
        for point, residual in zip(out["curve"], seen):
            point["stiefel_residual"] = residual
        return out

    module.convergence_metric = recording
    setattr(module, runner, driving)
    try:
        yield
    finally:
        module.convergence_metric = metric
        setattr(module, runner, drive)


def dro_runs(dro, steps: int, perturb=None) -> list:
    """``dro.run(steps)``'s runs without ``us_per_step``, every curve point
    with its Stiefel residual; ``perturb`` maps the initial weights
    ``init_cnn`` draws to the ones the runs start from."""
    init = dro.fair.init_cnn
    if perturb is not None:
        dro.fair.init_cnn = lambda *a, **kw: perturb(init(*a, **kw))
    try:
        with residuals_recorded(dro, "run_method"):
            out = dro.run(steps)["dro"]
    finally:
        dro.fair.init_cnn = init
    return [{"method": r["method"], "curve": r["curve"]} for r in out]


def dro_main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    dro = benchmark("dro")
    s = dro_settings(dro)
    params = dro.fair.init_cnn(jax.random.PRNGKey(s["seed"]),
                               image_hw=s["stream"]["image_hw"])
    init = {k: _encode(v) for k, v in sorted(params.items())}
    runs = dro_runs(dro, s["steps"])
    if [r["method"] for r in runs] != list(s["methods"]):
        raise RuntimeError(f"the benchmark ran {[r['method'] for r in runs]}")
    sp = {r["method"]: {key: [0.0] * len(r["curve"])
                        for key in DRO_QUANTITIES} for r in runs}
    for member in range(ENSEMBLE):
        rng = np.random.default_rng(member + 1)

        def perturb(p):
            return {k: v * jnp.asarray(1.0 + PERTURBATION
                                       * rng.standard_normal(v.shape),
                                       v.dtype) for k, v in p.items()}

        _ensemble_gaps(sp, dro_runs(dro, s["steps"], perturb), runs,
                       DRO_QUANTITIES)
        print(f"dro ensemble member {member + 1} of {ENSEMBLE} done",
              flush=True)
    DRO_OUT.write_text(json.dumps({
        "settings": s, "spread": sp, "tolerance": dro_tolerance(sp),
        "init_params": init, "dro": runs}, indent=1) + "\n")
    print(f"wrote {DRO_OUT}")


# ---------------------------------------------------------------------------
# robust PCA (examples/robust_pca.py)
# ---------------------------------------------------------------------------


def pca_settings() -> dict:
    """The example's settings, read with ``ast`` from its source: the
    constants line ``D, R, M, N, RHO = ...``, the keys and arguments of its
    ``make_batches``, ``GRASSMANN.rand``, ``GossipSpec`` and ``GDAHyper``
    calls, the steps of its loop and its evaluation interval."""
    from repro.core.gda import GDAHyper
    from repro.core.gossip import GossipSpec

    tree = ast.parse(EXAMPLE.read_text())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Tuple):
            names = [t.id for t in node.targets[0].elts]
            if names == ["D", "R", "M", "N", "RHO"]:
                consts = dict(zip(names, ast.literal_eval(node.value)))
    calls = _calls(tree)
    mb_args, mb_kw = calls["make_batches"]
    data = {k: _literal(v, consts) for k, v in mb_kw.items()}
    gossip = {k: _literal(v, consts) for k, v in calls["GossipSpec"][1]
              .items()}
    hyper = {k: _literal(v, consts) for k, v in calls["GDAHyper"][1].items()}
    steps = eval_every = None
    for node in ast.walk(tree):
        if isinstance(node, ast.For) and getattr(node.iter.func, "id",
                                                 None) == "range":
            steps = ast.literal_eval(node.iter.args[0])
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
            eval_every = ast.literal_eval(node.right)
    if (consts["D"], consts["R"], consts["M"], consts["N"]) != (
            data["d"], data["r"], data["m"], data["n_nodes"]):
        raise RuntimeError(f"make_batches takes {data}, not {consts}")
    return {
        "source": "examples/robust_pca.py",
        "d": consts["D"], "r": consts["R"], "m": consts["M"],
        "n_nodes": consts["N"], "rho": consts["RHO"],
        "data_seed": _literal(mb_args[0], consts),
        "x0_seed": _literal(calls["rand"][0][0], consts),
        "make_batches": {k: v for k, v in data.items()
                         if k not in ("n_nodes", "m", "d", "r")},
        "topology": gossip["topology"], "k_steps": gossip.get("k_steps"),
        "k": GossipSpec(**gossip).k,
        "hyper": dataclasses.asdict(GDAHyper(**hyper)),
        "steps": steps, "eval_every": eval_every,
    }


def pca_arrays(s: dict) -> tuple:
    """(batches, true_basis, x0) as the example makes them."""
    import jax

    from repro.geometry import GRASSMANN
    from repro.objectives import robust_pca as rp

    batches, basis = rp.make_batches(
        jax.random.PRNGKey(s["data_seed"]), n_nodes=s["n_nodes"], m=s["m"],
        d=s["d"], r=s["r"], **s["make_batches"])
    x0 = GRASSMANN.rand(jax.random.PRNGKey(s["x0_seed"]), s["d"], s["r"])
    return batches, basis, x0


def pca_run(s: dict, x0=None, steps: int | None = None) -> dict:
    """The example's run (its code, with its settings ``s``): the curve
    after step t for t = 0 and every ``eval_every``, and after the last
    step, and Phi of DRGDA's first node and of pooled PCA.  ``x0``
    replaces the example's initial basis."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.core import DRGDA, GDAHyper, GossipSpec
    from repro.core.gda import broadcast_to_nodes
    from repro.core.metric import convergence_metric
    from repro.geometry import GRASSMANN
    from repro.objectives import robust_pca as rp

    batches, basis, x0_example = pca_arrays(s)
    x0 = x0_example if x0 is None else x0
    steps = s["steps"] if steps is None else steps
    n, m, rho = s["n_nodes"], s["m"], s["rho"]
    problem = rp.make_robust_pca_problem(rho=rho)
    opt = DRGDA(problem, GossipSpec(topology=s["topology"], n_nodes=n,
                                    k_steps=s["k_steps"]),
                GDAHyper(**s["hyper"]))
    state = opt.init(broadcast_to_nodes({"w": x0}, n), rp.init_y(n, m),
                     batches)
    step = opt.make_step(donate=False)

    def point(t, loss):
        mt = convergence_metric(problem, state.x, state.y, batches)
        return {"step": t, "loss": float(loss), "M_t": float(mt["M_t"]),
                "consensus_x": float(mt["consensus_x"]),
                "stiefel_residual": float(mt["stiefel_residual"]),
                "angle": float(GRASSMANN.dist(state.x["w"][0], basis))}

    curve = []
    for t in range(steps):
        state, metrics = step(state, batches)
        if t % s["eval_every"] == 0:
            curve.append(point(t, metrics.loss))
    curve.append(point(steps, metrics.loss))

    def worst_case(x):
        y_star = rp.robust_pca_y_star({"w": x}, batches, rho=rho)
        res = jnp.mean(jax.vmap(lambda z: rp.residuals(x, z))(
            batches["z"]), 0)
        return float(jnp.dot(y_star, res)
                     - rho * jnp.sum((y_star - 1.0 / m) ** 2))

    z = np.asarray(batches["z"].reshape(-1, s["d"]))
    pca_basis = jnp.asarray(np.linalg.eigh(z.T @ z)[1][:, -s["r"]:])
    return {"curve": curve, "phi": {"drgda": worst_case(state.x["w"][0]),
                                    "pca": worst_case(pca_basis)}}


def pca_tolerance(spread: dict) -> dict:
    """The gates of the example's curve, and of ``phi`` (relative; no
    horizon, one number each)."""
    tol = tolerance({"drgda": spread["drgda"]}, PCA_CPU_GAP)
    tol["phi"] = {name: max(SPREAD_FACTOR * v,
                            CPU_FACTOR * PCA_CPU_GAP["phi"][name], FLOOR)
                  for name, v in spread["phi"].items()}
    return tol


def pca_main() -> None:
    import jax.numpy as jnp
    import numpy as np

    s = pca_settings()
    batches, basis, x0 = pca_arrays(s)
    ref = pca_run(s)
    sp = {"drgda": {key: [0.0] * len(ref["curve"])
                    for key in PCA_QUANTITIES}}
    phi_sp = dict.fromkeys(ref["phi"], 0.0)
    for member in range(ENSEMBLE):
        rng = np.random.default_rng(member + 1)
        x0p = x0 * jnp.asarray(1.0 + PERTURBATION
                               * rng.standard_normal(x0.shape), x0.dtype)
        got = pca_run(s, x0p)
        _ensemble_gaps(sp, [{"method": "drgda", "curve": got["curve"]}],
                       [ref], PCA_QUANTITIES)
        for name, want in ref["phi"].items():
            phi_sp[name] = max(phi_sp[name],
                               abs(got["phi"][name] - want) / abs(want))
        print(f"robust_pca ensemble member {member + 1} of {ENSEMBLE} done",
              flush=True)
    sp["phi"] = phi_sp
    PCA_OUT.write_text(json.dumps({
        "settings": s, "spread": sp, "tolerance": pca_tolerance(sp),
        "batches": {"z": _encode(batches["z"])},
        "true_basis": _encode(basis), "x0": _encode(x0),
        "curve": ref["curve"], "phi": ref["phi"]}, indent=1) + "\n")
    print(f"wrote {PCA_OUT}")


# ---------------------------------------------------------------------------
# elastic gossip (benchmarks/elastic.py)
# ---------------------------------------------------------------------------


def elastic_settings(el) -> dict:
    """What ``el.run()`` runs, read from the benchmark: ``N``, the
    schedules, the defaults of ``run``, ``run_fair`` and ``run_pca``, and
    the arguments of the calls in ``run_fair`` and ``run_pca``."""
    from repro.core.gda import GDAHyper
    from repro.data.synthetic import ClassificationStream

    fair_calls = _calls(ast.parse(inspect.getsource(el.run_fair)))
    pca_calls = _calls(ast.parse(inspect.getsource(el.run_pca)))
    run, run_fair, run_pca = (_defaults(el.run), _defaults(el.run_fair),
                              _defaults(el.run_pca))

    def kw(calls, name):
        """The call's keyword arguments that are constants (or ``N``)."""
        out = {}
        for k, v in calls[name][1].items():
            try:
                out[k] = _literal(v, {"N": el.N})
            except (KeyError, ValueError):
                pass
        return out

    mb = kw(pca_calls, "make_batches")
    rand_args = [_literal(a, {}) for a in pca_calls["rand"][0]]
    return {
        "source": "benchmarks/elastic.py run()",
        "n_nodes": el.N, "topology": "ring", "k_steps": 1,
        "schedules": {name: (None if spec is None
                             else dataclasses.asdict(spec))
                      for name, spec in el.SCHEDULES.items()},
        "fair": {
            "steps": run["steps_fair"], "seed": run_fair["seed"],
            "batch_per_node": kw(fair_calls, "ClassificationStream")[
                "batch_per_node"],
            "image_hw": _defaults(ClassificationStream)["image_hw"],
            "full_batches": kw(fair_calls, "full")["n_batches"],
            "rho": kw(fair_calls, "make_fair_problem")["rho"],
            "hyper": dataclasses.asdict(GDAHyper(**kw(fair_calls,
                                                      "GDAHyper"))),
            "eval_every": kw(fair_calls, "_drive")["eval_every"]},
        "pca": {
            "steps": run["steps_pca"], "seed": run_pca["seed"],
            "x0_seed": rand_args[0], "d": mb["d"], "r": mb["r"],
            "m": mb["m"], "outlier_frac": mb["outlier_frac"],
            "outlier_scale": mb["outlier_scale"],
            "rho": kw(pca_calls, "make_robust_pca_problem")["rho"],
            "hyper": dataclasses.asdict(GDAHyper(**kw(pca_calls,
                                                      "GDAHyper"))),
            "eval_every": kw(pca_calls, "_drive")["eval_every"]},
    }


def elastic_draws(el, rounds: int) -> dict:
    """The uniforms behind every churn and straggler draw of ``el.run()``
    for rounds 0 .. ``rounds`` - 1, from the JAX package's keys
    (``ElasticJaxDraws``): ``churn`` leave / join (n,) per round, and
    ``straggle`` per slot.  Every schedule of the benchmark draws from the
    same seeds (ElasticSpec.seed and CommSpec.seed 0), so one record serves
    them all; a schedule with other seeds or a drop rate raises."""
    import numpy as np
    from _jax_draws import ElasticJaxDraws

    specs = [spec for spec in el.SCHEDULES.values() if spec is not None]
    if any(spec.seed != 0 or spec.drop_rate > 0.0 for spec in specs):
        raise RuntimeError("the record assumes seed 0 and no link drops")
    n = el.N
    strag = next(spec for spec in specs if spec.straggler_rate > 0.0)
    churn = ElasticJaxDraws(specs[0])
    faults = ElasticJaxDraws(strag)

    def rows(source, stream):
        return np.stack([source.uniform(stream, rnd, 0, (n,), "cpu").numpy()
                         for rnd in range(rounds)])

    return {"rounds": rounds,
            "churn": {k: _encode(rows(churn, f"elastic/churn/{k}"))
                      for k in ("leave", "join")},
            "straggle": {slot: _encode(rows(faults, f"{slot}/chan/straggle"))
                         for slot in ELASTIC_SLOTS}}


def elastic_runs(el, perturb=None) -> dict:
    """``el.run()``'s runs without ``us_per_step``, per problem, every
    curve point with its Stiefel residual; ``perturb`` maps each
    single-node start (the CNN weights, the PCA basis) before it is
    broadcast to the nodes."""
    broadcast = el.broadcast_to_nodes
    if perturb is not None:
        el.broadcast_to_nodes = lambda tree, n: broadcast(perturb(tree), n)
    try:
        with residuals_recorded(el, "_drive"):
            out = el.run()
    finally:
        el.broadcast_to_nodes = broadcast
    keep = ("problem", "schedule", "curve", "final_M_t", "final_consensus",
            "finite")
    return {problem: [{k: r[k] for k in keep} for r in out[problem]]
            for problem in ("fair_classification", "robust_pca")} | {
        k: out[k] for k in ("leave_rejoin_Mt_ratio", "leave_rejoin_within_2x",
                            "all_finite")}


def elastic_tolerance(spread: dict) -> dict:
    """The gates of the elastic curves, per problem and schedule, the
    Stiefel residual's (recorded by :func:`residuals_recorded`) at ten
    times the port's CPU gap."""
    return {problem: tolerance(per_schedule, ELASTIC_CPU_GAP[problem])
            for problem, per_schedule in spread.items()}


def elastic_main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    el = benchmark("elastic")
    s = elastic_settings(el)
    params = el.fair.init_cnn(jax.random.PRNGKey(s["fair"]["seed"]),
                              image_hw=s["fair"]["image_hw"])
    batches, _ = el.rp.make_batches(
        jax.random.PRNGKey(s["pca"]["seed"]), n_nodes=s["n_nodes"],
        m=s["pca"]["m"], d=s["pca"]["d"], r=s["pca"]["r"],
        outlier_frac=s["pca"]["outlier_frac"],
        outlier_scale=s["pca"]["outlier_scale"])
    x0 = el.GRASSMANN.rand(jax.random.PRNGKey(s["pca"]["x0_seed"]),
                           s["pca"]["d"], s["pca"]["r"])
    out = elastic_runs(el)
    problems = ("fair_classification", "robust_pca")
    sp = {p: {r["schedule"]: {key: [0.0] * len(r["curve"])
                              for key in ELASTIC_QUANTITIES}
              for r in out[p]} for p in problems}
    for member in range(ENSEMBLE):
        rng = np.random.default_rng(member + 1)

        def perturb(tree):
            return {k: v * jnp.asarray(1.0 + PERTURBATION
                                       * rng.standard_normal(v.shape),
                                       v.dtype) for k, v in tree.items()}

        got = elastic_runs(el, perturb)
        for p in problems:
            for r, want in zip(got[p], out[p]):
                if [a["live"] for a in r["curve"]] != [
                        b["live"] for b in want["curve"]]:
                    raise RuntimeError(f"{p} {r['schedule']}: membership "
                                       "depends on the weights")
            _ensemble_gaps(sp[p], [{"method": r["schedule"], **r}
                                   for r in got[p]],
                           out[p], ELASTIC_QUANTITIES)
        print(f"elastic ensemble member {member + 1} of {ENSEMBLE} done",
              flush=True)
    rounds = max(s["fair"]["steps"], s["pca"]["steps"])
    ELASTIC_OUT.write_text(json.dumps({
        "settings": s, "spread": sp, "tolerance": elastic_tolerance(sp),
        "init_params": {k: _encode(v) for k, v in sorted(params.items())},
        "pca_batches": {"z": _encode(batches["z"])}, "pca_x0": _encode(x0),
        "draws": elastic_draws(el, rounds), **out}, indent=1) + "\n")
    print(f"wrote {ELASTIC_OUT}")


# ---------------------------------------------------------------------------
# decentralized LM training (launch/train.py's trainer)
# ---------------------------------------------------------------------------

LM_OUT = ROOT / "tests" / "data" / "lm_reference.json"
LM_SETTINGS = {
    "source": "src/repro/launch/steps.py build_trainer (default hyper), "
              "src/repro/launch/train.py (batch 0 for the init, batch t+1 "
              "for step t, M_t on the step's batch)",
    "arch": "smollm-135m", "n_layers": 2, "n_nodes": 4,
    "batch_per_node": 2, "seq_len": 64, "optimizer": "drsgda",
    "topology": "ring", "steps": 10, "eval_steps": [5, 10],
    "params_seed": 0, "stream_seed": 0,
}
LM_STEP_KEYS = ("loss", "grad_norm_x", "consensus_x")
LM_EVAL_KEYS = ("M_t", "stiefel_residual")
# The port's largest gap from the recorded run on the CPU, per curve and
# quantity (relative; `python -m repro_torch.launch.train --reference
# --device cpu`).
LM_CPU_GAP = {
    "steps": {"loss": 4.220e-07, "grad_norm_x": 3.632e-07,
              "consensus_x": 4.030e-07},
    "evals": {"M_t": 7.022e-08, "stiefel_residual": 2.282e-06},
}


def lm_config(settings: dict = LM_SETTINGS):
    """A recorded run's model: ``settings["arch"]``'s ``SMOKE`` config
    where ``settings["smoke"]``, else its published widths cut to
    ``settings["n_layers"]`` blocks that take the distinct blocks of its
    published pattern in turn, in their order (a uniform configuration:
    one stacked stage of its block; zamba2-2.7b: a Mamba2 block, then
    attention)."""
    from repro import configs
    from repro.configs.base import patterned_stages, uniform_stages

    if settings.get("smoke"):
        return configs.get_config(settings["arch"], smoke=True)
    cfg = configs.get_config(settings["arch"])
    n = settings["n_layers"]
    kinds = list(dict.fromkeys(cfg.flat_blocks()))
    stages = uniform_stages(kinds[0], n) if len(kinds) == 1 \
        else patterned_stages(kinds, n)
    return dataclasses.replace(cfg, stages=stages,
                               name=f"{cfg.name}-{n}L")


def lm_run(cfg, hyper, params, s: dict = LM_SETTINGS) -> dict:
    """The JAX trainer from one node's ``params`` (projected onto the
    manifold, broadcast), as ``launch/train.py`` steps it, every step's
    metrics and M_t at the evaluation steps; a model with a frontend gets
    ``convert.lm_frontend_from_seed``'s embeddings in every batch."""
    import jax
    import jax.numpy as jnp

    from repro.core.gda import broadcast_to_nodes
    from repro.core.metric import convergence_metric
    from repro.data.synthetic import TokenStream
    from repro.launch.steps import build_trainer
    from repro.objectives.lm import init_y
    from repro.sharding.partition import project_params_to_manifold

    opt, problem = build_trainer(cfg, s["n_nodes"], optimizer=s["optimizer"],
                                 hyper=hyper, topology=s["topology"])
    stream = TokenStream(n_nodes=s["n_nodes"],
                         batch_per_node=s["batch_per_node"],
                         seq_len=s["seq_len"], vocab_size=cfg.vocab_size,
                         n_groups=cfg.n_groups, n_codebooks=cfg.n_codebooks,
                         seed=s["stream_seed"])
    fe = None
    if cfg.frontend is not None:
        from repro_torch.convert import lm_frontend_from_seed
        fe = jnp.asarray(lm_frontend_from_seed(
            cfg, s["n_nodes"], s["batch_per_node"], s["frontend_seed"]))

    def batch(t):
        b = {k: jnp.asarray(v) for k, v in stream.batch(t).items()}
        if fe is not None:
            b["frontend_embeds"] = fe
        return b

    x0 = broadcast_to_nodes(project_params_to_manifold(
        jax.tree.map(jnp.asarray, params), opt.problem.manifold_map),
        s["n_nodes"])
    state = jax.jit(lambda x, y, b: opt.init(x, y, b))(
        x0, init_y(cfg, s["n_nodes"]), batch(0))
    # donated, as the JAX CLI steps it: the state's memory is reused
    step = opt.make_step(donate=True)
    metric = jax.jit(lambda x, y, b: convergence_metric(problem, x, y, b))
    steps, evals = [], []
    for t in range(s["steps"]):
        b = batch(t + 1)
        state, m = step(state, b)
        steps.append({"step": t + 1, **{k: float(getattr(m, k))
                                        for k in LM_STEP_KEYS}})
        if t + 1 in s["eval_steps"]:
            mm = metric(state.x, state.y, b)
            evals.append({"step": t + 1,
                          **{k: float(mm[k]) for k in LM_EVAL_KEYS}})
    return {"steps": steps, "evals": evals}


def lm_tolerance(spread: dict, cpu_gap: dict | None = None) -> dict:
    """The gates of both curves: :func:`tolerance` with ``cpu_gap``
    (default :data:`LM_CPU_GAP`); the Stiefel residual's (absolute, as
    :func:`gap` counts it) without ``FLOOR``, which lies above the
    residual itself (about 1.8e-5): ten times the spread or the port's CPU
    gap."""
    cpu_gap = LM_CPU_GAP if cpu_gap is None else cpu_gap
    out = tolerance(spread, cpu_gap, residual=False)
    out["evals"]["stiefel_residual"] = [
        max(SPREAD_FACTOR * sp, CPU_FACTOR
            * cpu_gap["evals"]["stiefel_residual"])
        for sp in spread["evals"]["stiefel_residual"]]
    return out


def lm_record(settings: dict, cpu_gap: dict) -> dict:
    """One recorded LM run at ``settings`` and its ensemble: ``settings``
    (with the hyper), ``spread``, ``tolerance`` (from ``cpu_gap``),
    ``steps`` and ``evals``."""
    import numpy as np

    from repro.core.gda import GDAHyper
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.convert import lm_params_from_seed

    cfg = lm_config(settings)
    # build_trainer's default hyper (launch/steps.py), written out
    hyper = GDAHyper(alpha=0.5, beta=0.02, eta=0.05)
    params = lm_params_from_seed(cfg, settings["params_seed"])
    ref = lm_run(cfg, hyper, params, settings)
    print(f"{settings['arch']} reference run done", flush=True)
    sp = {"steps": {k: [0.0] * len(ref["steps"]) for k in LM_STEP_KEYS},
          "evals": {k: [0.0] * len(ref["evals"]) for k in LM_EVAL_KEYS}}
    for member in range(ENSEMBLE):
        rng = np.random.default_rng(member + 1)

        def perturb(a):
            return (a * (1.0 + PERTURBATION * rng.standard_normal(a.shape))
                    ).astype(np.float32)

        def walk(tree):
            return {k: walk(v) if isinstance(v, dict) else perturb(v)
                    for k, v in tree.items()}

        got = lm_run(cfg, hyper, walk(params), settings)
        for c, keys in (("steps", LM_STEP_KEYS), ("evals", LM_EVAL_KEYS)):
            for key in keys:
                pts = sp[c][key]
                for i, (a, b) in enumerate(zip(got[c], ref[c])):
                    pts[i] = max(pts[i], gap(a, b, key))
        print(f"{settings['arch']} ensemble member {member + 1} of "
              f"{ENSEMBLE} done", flush=True)
    return {"settings": {**settings, "hyper": dataclasses.asdict(hyper)},
            "spread": sp, "tolerance": lm_tolerance(sp, cpu_gap), **ref}


def lm_main() -> None:
    LM_OUT.write_text(json.dumps(lm_record(LM_SETTINGS, LM_CPU_GAP),
                                 indent=1) + "\n")
    print(f"wrote {LM_OUT}")


LM_MODELS_OUT = ROOT / "tests" / "data" / "lm_models_reference.json"
#: the recorded runs of ``lm_models``: ``lm``'s settings, with the
#: architecture, its size (published widths cut to ``n_layers``, or
#: ``SMOKE``) and the seed of a frontend's embeddings
LM_MODELS = {
    arch: {**LM_SETTINGS, "arch": arch, "smoke": smoke,
           "n_layers": None if smoke else 2, "frontend_seed": 0}
    for arch, smoke in (("granite-moe-1b-a400m", False),
                        ("musicgen-large", False),
                        ("deepseek-v2-236b", True),
                        ("llama-3.2-vision-11b", True),
                        ("zamba2-2.7b", True))}
# The port's largest gap from each recorded run on the CPU over the gated
# points, as LM_CPU_GAP (`python -m repro_torch.launch.train --reference
# --reference-arch <arch> --device cpu`; where a quantity has no gated
# point, over all of them; the Stiefel residual's, absolute, over all).
LM_MODELS_CPU_GAP = {
    "granite-moe-1b-a400m": {
        "steps": {"loss": 2.525e-07, "grad_norm_x": 3.528e-07,
                  "consensus_x": 5.145e-07},
        "evals": {"M_t": 8.456e-07, "stiefel_residual": 1.373e-06}},
    "musicgen-large": {
        "steps": {"loss": 2.397e-07, "grad_norm_x": 1.924e-07,
                  "consensus_x": 3.688e-07},
        "evals": {"M_t": 1.856e-07, "stiefel_residual": 3.248e-06}},
    "deepseek-v2-236b": {
        "steps": {"loss": 1.798e-07, "grad_norm_x": 3.208e-07,
                  "consensus_x": 4.368e-07},
        "evals": {"M_t": 1.423e-07, "stiefel_residual": 1.186e-07}},
    "llama-3.2-vision-11b": {
        "steps": {"loss": 1.828e-07, "grad_norm_x": 3.314e-07,
                  "consensus_x": 3.269e-07},
        "evals": {"M_t": 4.158e-07, "stiefel_residual": 2.360e-07}},
    "zamba2-2.7b": {
        "steps": {"loss": 1.634e-07, "grad_norm_x": 2.124e-07,
                  "consensus_x": 3.301e-07},
        "evals": {"M_t": 1.068e-07, "stiefel_residual": 4.584e-08}},
}


def lm_models_main(only: str = "") -> None:
    """Record every run of :data:`LM_MODELS` (or ``only`` that one),
    rewriting the file after each."""
    out = json.loads(LM_MODELS_OUT.read_text()) if LM_MODELS_OUT.exists() \
        else {"runs": {}}
    for arch, settings in LM_MODELS.items():
        if only and arch != only:
            continue
        out["runs"][arch] = lm_record(settings, LM_MODELS_CPU_GAP[arch])
        LM_MODELS_OUT.write_text(json.dumps(out, indent=1) + "\n")
        print(f"wrote {arch} to {LM_MODELS_OUT}", flush=True)


def lm_models_tolerance_all(out: dict) -> dict:
    """:func:`retolerance`'s rewrite of ``lm_models``' file: every run's
    gates from its stored spread and :data:`LM_MODELS_CPU_GAP`."""
    for arch, run in out["runs"].items():
        run["tolerance"] = lm_tolerance(run["spread"],
                                        LM_MODELS_CPU_GAP[arch])
    return out


def retolerance(name: str) -> None:
    """Rewrite the gates of target ``name``'s file from its stored spread
    (after its CPU gaps are re-measured), without running JAX again."""
    path, gates = RETOLERANCE[name]
    out = json.loads(path.read_text())
    if name == "lm_models":
        out = lm_models_tolerance_all(out)
    else:
        out["tolerance"] = gates(out["spread"])
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"rewrote the gates of {path}")


TARGETS = {"fair": fair_main, "dro": dro_main, "robust_pca": pca_main,
           "elastic": elastic_main, "lm": lm_main,
           "lm_models": lm_models_main}
RETOLERANCE = {"fair": (OUT, tolerance), "dro": (DRO_OUT, dro_tolerance),
               "robust_pca": (PCA_OUT, pca_tolerance),
               "elastic": (ELASTIC_OUT, elastic_tolerance),
               "lm": (LM_OUT, lm_tolerance),
               "lm_models": (LM_MODELS_OUT, None)}


def main(argv=None) -> None:
    os.environ.setdefault("REPRO_TUNE", "off")
    names = (sys.argv[1:] if argv is None else argv) or list(TARGETS)
    for name in names:
        if name.endswith("_retolerance"):
            retolerance(name[:-len("_retolerance")])
            continue
        if name.startswith("lm_models:"):
            lm_models_main(name.split(":", 1)[1])
            continue
        TARGETS[name]()


if __name__ == "__main__":
    main()
